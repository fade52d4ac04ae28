"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips on a machine without a
CUDA device (a CUDA kernel has no host mode).  This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.generators import rmat
from repro_torch.graph.structs import build_ell
from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
from repro_torch.kernels.segment_spmm.ref import coo_spmm_ref, ell_spmm_ref

TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of an fp32 sum
SHAPES = [(50, 16, 8, 128), (100, 7, 3, 64), (30, 4, 16, 16), (64, 32, 1, 256), (40, 9, 8, 1),
          (300, 5, 1500, 1), (300, 5, 1500, 3), (90, 33, 40, 20)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernel has no host mode")


def _inputs(n, r, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cols = rng.integers(0, n + 10, (r, w)).astype(np.int32)  # >= n hits padding
    wts = rng.standard_normal((r, w)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(cols).cuda(), torch.from_numpy(wts).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("with_wts", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,R,W,D", SHAPES)
def test_kernel_matches_plain_version(N, R, W, D, dtype, with_wts):
    _need_card()
    x, cols, wts = _inputs(N, R, W, D)
    x, wts = x.to(dtype), (wts if with_wts else None)
    before = ell_spmm.launches
    got = ell_spmm(x, cols, wts)
    assert ell_spmm.launches == before + 1
    want = ell_spmm_ref(x, cols, wts)
    assert got.dtype == dtype and got.shape == (R, D)
    torch.testing.assert_close(got.float(), want.float(), **(TOL if dtype == torch.float32 else BF16_TOL))
    assert torch.equal(got, ell_spmm(x, cols, wts))  # one owner per element, fixed order


@pytest.mark.gpu
def test_unaligned_views_take_the_scalar_path():
    _need_card()
    x, cols, wts = _inputs(64, 20, 8, 33)  # D = 33: no 16-byte rows
    torch.testing.assert_close(ell_spmm(x, cols, wts), ell_spmm_ref(x, cols, wts), **TOL)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take():
    _need_card()
    x, cols, wts = _inputs(50, 16, 8, 16)
    with pytest.raises(TypeError):
        ell_spmm(x.double(), cols, wts)
    with pytest.raises(TypeError):
        ell_spmm(x, cols.long(), wts)
    with pytest.raises(ValueError):
        ell_spmm(x, cols.t(), None)  # not contiguous
    with pytest.raises(ValueError):
        ell_spmm(x, cols.cpu(), wts)
    before = ell_spmm.launches
    assert ell_spmm(x, cols[:0], None).shape == (0, 16) and ell_spmm.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_whole_graph_equals_coo_oracle(seed):
    _need_card()
    g = rmat(1500, 20_000, seed=seed, weighted=True)
    ell = build_ell(g.reversed())  # device=None is the card
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1500, 32)).astype(np.float32)).cuda()
    got = segment_spmm(x, ell)
    want = coo_spmm_ref(x, torch.from_numpy(g.src).cuda(), torch.from_numpy(g.dst).cuda(),
                        torch.from_numpy(g.weight).cuda(), 1500)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
