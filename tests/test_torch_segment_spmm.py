"""`repro_torch.kernels.segment_spmm` against the JAX package's ELL SpMM on
the same seeded numpy inputs.  On the CPU the port's wrapper takes the plain
PyTorch version; the CUDA kernel itself is held against that version on the
card (`tests/test_torch_gpu_kernels.py`, and `chip_smoke.py`)."""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.generators import rmat as jax_rmat
from repro.graph.structs import build_ell as jax_build_ell
from repro.kernels.segment_spmm.kernel import ell_spmm_pallas
from repro.kernels.segment_spmm.ref import coo_spmm_ref as jax_coo_spmm_ref
from repro.kernels.segment_spmm.ref import ell_spmm_ref as jax_ell_spmm_ref
from repro_torch.graph.generators import rmat
from repro_torch.graph.structs import ELL_HUB_WIDTH, ELL_ITEM_SLOTS, HostGraph, build_ell
from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
from repro_torch.kernels.segment_spmm.ref import coo_spmm_ref, ell_spmm_ref, segment_spmm_ref

TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # bf16 products/rounding differ between frameworks

SHAPES = [(50, 16, 8, 128), (100, 7, 3, 64), (30, 4, 16, 16), (64, 32, 1, 256), (40, 9, 8, 1)]


def _inputs(n, r, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cols = rng.integers(0, n + 10, (r, w)).astype(np.int32)  # ≥ n hits padding
    wts = rng.standard_normal((r, w)).astype(np.float32)
    return x, cols, wts


@pytest.mark.parametrize("N,R,W,D", SHAPES)
def test_bucket_f32_matches_jax_kernel_and_ref(N, R, W, D):
    x, cols, wts = _inputs(N, R, W, D)
    got = ell_spmm_ref(torch.from_numpy(x), torch.from_numpy(cols), torch.from_numpy(wts)).numpy()
    pallas = np.asarray(ell_spmm_pallas(jnp.asarray(x), jnp.asarray(cols), jnp.asarray(wts), interpret=True))
    ref = np.asarray(jax_ell_spmm_ref(jnp.asarray(x), jnp.asarray(cols), jnp.asarray(wts)))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("N,R,W,D", SHAPES)
def test_bucket_bf16_matches_jax_kernel_and_ref(N, R, W, D):
    x, cols, wts = _inputs(N, R, W, D, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ell_spmm_ref(xb, torch.from_numpy(cols), torch.from_numpy(wts))
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)  # the same bf16 values
    pallas = ell_spmm_pallas(xj, jnp.asarray(cols), jnp.asarray(wts), interpret=True)
    ref = jax_ell_spmm_ref(xj, jnp.asarray(cols), jnp.asarray(wts))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)), **BF16_TOL)
    # the JAX ref multiplies and sums in bf16; widen by its own rounding over W terms
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=2e-2, atol=2e-2 * max(1, W) ** 0.5
    )


@pytest.mark.parametrize("N,R,W,D", SHAPES[:2])
def test_padding_and_no_weights(N, R, W, D):
    x, cols, _ = _inputs(N, R, W, D, seed=2)
    cols[0, :] = N  # a row of nothing but padding
    got = ell_spmm_ref(torch.from_numpy(x), torch.from_numpy(cols), None).numpy()
    want = np.asarray(jax_ell_spmm_ref(jnp.asarray(x), jnp.asarray(cols), None))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0.0)
    # wts=None is all ones
    ones = torch.ones((R, W))
    assert torch.equal(
        ell_spmm_ref(torch.from_numpy(x), torch.from_numpy(cols), ones),
        ell_spmm_ref(torch.from_numpy(x), torch.from_numpy(cols), None),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_ell_equals_jax_bucket_for_bucket(seed):
    g, jg = rmat(150, 900, seed=seed), jax_rmat(150, 900, seed=seed)
    from repro_torch.graph.algorithms import pagerank_edge_weights
    from repro.graph.algorithms import pagerank_edge_weights as jax_pew

    for a, b in ((g, jg), (pagerank_edge_weights(g), jax_pew(jg))):
        ell, jell = build_ell(a.reversed(), device="cpu"), jax_build_ell(b.reversed())
        assert ell.widths == jell.widths and ell.num_nodes == jell.num_nodes
        assert (ell.weights is None) == (jell.weights is None)
        for k in range(ell.num_buckets):
            assert ell.rows[k].dtype == torch.int32 and ell.cols[k].dtype == torch.int32
            np.testing.assert_array_equal(ell.rows[k].numpy(), np.asarray(jell.rows[k]))
            np.testing.assert_array_equal(ell.cols[k].numpy(), np.asarray(jell.cols[k]))
            if ell.weights is not None:
                assert ell.weights[k].dtype == torch.float32
                np.testing.assert_array_equal(ell.weights[k].numpy(), np.asarray(jell.weights[k]))
        assert ell.fill_fraction() == pytest.approx(jell.fill_fraction())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_whole_graph_equals_coo_oracles(seed):
    g = rmat(150, 900, seed=seed)
    ell = build_ell(g.reversed(), device="cpu")
    x = np.random.default_rng(seed).standard_normal((150, 32)).astype(np.float32)
    got = segment_spmm(torch.from_numpy(x), ell).numpy()
    want = coo_spmm_ref(torch.from_numpy(x), torch.from_numpy(g.src), torch.from_numpy(g.dst), None, 150).numpy()
    jwant = np.asarray(jax_coo_spmm_ref(jnp.asarray(x), jnp.asarray(g.src), jnp.asarray(g.dst), None, 150))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, jwant, rtol=1e-3, atol=1e-4)


def test_whole_graph_weighted_min_width_4():
    g = rmat(60, 240, seed=3, weighted=True)
    ell = build_ell(g.reversed(), min_width=4, device="cpu")
    x = np.random.default_rng(0).standard_normal((60, 16)).astype(np.float32)
    got = segment_spmm(torch.from_numpy(x), ell).numpy()
    jwant = np.asarray(
        jax_coo_spmm_ref(jnp.asarray(x), jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(g.weight), 60)
    )
    np.testing.assert_allclose(got, jwant, rtol=1e-3, atol=1e-4)


def test_cpu_tensor_takes_ref_and_counts_no_launch():
    x, cols, wts = _inputs(50, 16, 8, 16)
    before = ell_spmm.launches
    got = ell_spmm(torch.from_numpy(x), torch.from_numpy(cols), torch.from_numpy(wts))
    assert ell_spmm.launches == before
    assert torch.equal(got, ell_spmm_ref(torch.from_numpy(x), torch.from_numpy(cols), torch.from_numpy(wts)))
    with pytest.raises(ValueError):
        ell_spmm(torch.from_numpy(x), torch.from_numpy(cols), None, impl="pallas")


def test_cuda_impl_refuses_cpu_tensor_without_fallback():
    x, cols, wts = _inputs(50, 16, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ell_spmm(torch.from_numpy(x), torch.from_numpy(cols), torch.from_numpy(wts), impl="cuda")


def test_kernel_module_imports_without_cuda_or_nvcc():
    """The build happens at the first launch, never at import."""
    mod = importlib.import_module("repro_torch.kernels.segment_spmm.kernel")
    assert callable(mod.ell_spmm_cuda) and callable(mod.build)
    # a fresh interpreter with no nvcc to be found: importing must still work
    code = (
        "import repro_torch.kernels.segment_spmm.kernel as k, repro_torch.kernels.build as b; "
        "assert (b.CSRC_DIR / 'ell_spmm.cu').is_file(); print('imported')"
    )
    env = {"PYTHONPATH": os.pathsep.join(sys.path), "PATH": ""}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert done.returncode == 0 and "imported" in done.stdout, done.stderr


def test_empty_bucket_returns_empty():
    x = torch.zeros((10, 4))
    out = ell_spmm(x, torch.zeros((0, 8), dtype=torch.int32), None)
    assert out.shape == (0, 4)


def _graph(seed, weighted):
    """`test_whole_graph_equals_coo_oracles`'s R-MAT graph, weighted or not,
    with 20 more vertices that have no edge at all."""
    g = rmat(150, 900, seed=seed, weighted=weighted)
    return HostGraph(170, g.src, g.dst, g.weight)


@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_work_table_covers_every_real_row_once(seed, weighted, d):
    g = _graph(seed, weighted)
    ell = build_ell(g.reversed(), device="cpu")
    work = ell.work()
    items = work.items.numpy()
    assert items.dtype == np.int64 and items.shape[1] == 4
    assert list(items[:, 2]) == sorted(items[:, 2], reverse=True)  # hubs (widest rows) first
    # the flat buffers are the buckets, and the buckets are views into them
    assert torch.equal(work.cols, torch.cat([c.reshape(-1) for c in ell.cols]))
    assert torch.equal(work.rows, torch.cat(ell.rows))
    if weighted:
        assert torch.equal(work.weights, torch.cat([w.reshape(-1) for w in ell.weights]))
        assert all(w.untyped_storage().data_ptr() == work.weights.untyped_storage().data_ptr() for w in ell.weights)
    else:
        assert work.weights is None and ell.weights is None
    assert all(c.untyped_storage().data_ptr() == work.cols.untyped_storage().data_ptr() for c in ell.cols)
    seen = np.zeros(work.rows.numel(), dtype=np.int64)
    row0 = np.cumsum([0] + [int(r.numel()) for r in ell.rows])
    slot0 = np.cumsum([0] + [int(c.numel()) for c in ell.cols])
    for first, count, width, slot in items:
        b = ell.widths.index(int(width))
        assert row0[b] <= first and first + count <= row0[b + 1]  # an item stays inside its bucket
        assert slot == slot0[b] + (first - row0[b]) * width
        assert count == 1 if width >= ELL_HUB_WIDTH else count <= max(1, ELL_ITEM_SLOTS // width)
        seen[first : first + count] += 1
    assert np.all(seen == 1)  # every row of every bucket, padded ones included, exactly once
    rows = work.rows.numpy()
    real = rows[rows < g.num_nodes]
    indeg = np.bincount(g.dst, minlength=g.num_nodes)
    assert np.array_equal(np.sort(real), np.nonzero(indeg > 0)[0])  # each such vertex in one real row
    assert np.array_equal(np.sort(work.zero_rows.numpy()), np.nonzero(indeg == 0)[0])
    assert (indeg == 0).sum() >= 20


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_layout_reader_equals_jax_coo_oracle(seed, weighted):
    g = _graph(seed, weighted)
    ell = build_ell(g.reversed(), device="cpu")
    x = np.random.default_rng(seed).standard_normal((g.num_nodes, 16)).astype(np.float32)
    got = segment_spmm_ref(torch.from_numpy(x), ell).numpy()
    jw = None if g.weight is None else jnp.asarray(g.weight)
    jwant = np.asarray(jax_coo_spmm_ref(jnp.asarray(x), jnp.asarray(g.src), jnp.asarray(g.dst), jw, g.num_nodes))
    np.testing.assert_allclose(got, jwant, **TOL)
    np.testing.assert_array_equal(got, segment_spmm(torch.from_numpy(x), ell, impl="ref").numpy())
    isolated = np.nonzero(np.bincount(g.dst, minlength=g.num_nodes) == 0)[0]
    assert isolated.size >= 20 and np.all(got[isolated] == 0.0)


def test_fused_route_refuses_cpu_tensors_without_fallback():
    g = _graph(0, True)
    ell = build_ell(g.reversed(), device="cpu")
    x = torch.ones((g.num_nodes, 4))
    before = segment_spmm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_spmm(x, ell, impl="cuda")
    with pytest.raises(ValueError):
        segment_spmm(x, ell, impl="buckets")
    assert segment_spmm.launches == before
    assert torch.equal(segment_spmm(x, ell), segment_spmm_ref(x, ell))  # auto on the CPU: the plain reader
