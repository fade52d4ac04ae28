"""`repro_torch.kernels.flash_attention` against the JAX package's attention on
the same seeded numpy inputs.  JAX runs as its own tests run it on the CPU
(the Pallas kernel with `interpret=True`, the plain `gqa_attention` and the
blocked `flash_attention_ref`); the port runs its plain versions.  The CUDA
kernel itself is held against those on the card
(`tests/test_torch_gpu_kernels.py`, and `chip_smoke.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import gqa_attention as jax_gqa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, naive_attention_ref

TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order (tests/test_kernels.py)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of an fp32 result

# tests/test_kernels.py:24-29: (B, Sq, Skv, Hq, Hkv, dh)
SHAPES = [
    (2, 128, 128, 4, 2, 64),
    (1, 256, 256, 8, 1, 32),   # MQA
    (2, 96, 160, 4, 4, 64),    # cross lengths
    (1, 200, 200, 6, 2, 128),  # non-divisible seq
]
DTYPES = {"f32": (jnp.float32, torch.float32, TOL), "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _qkv(b, sq, skv, hq, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32))


def _both(arrays, tag):
    jdt, tdt, _ = DTYPES[tag]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh", SHAPES)
def test_plain_versions_match_jax_kernel_and_gqa(b, sq, skv, hq, hkv, dh, causal, tag):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, sq, skv, hq, hkv, dh), tag)
    tol = DTYPES[tag][2]
    off = skv - sq if causal else 0
    want_kernel = flash_attention_pallas(jq, jk, jv, causal=causal, q_offset=off,
                                         block_q=64, block_k=64, interpret=True)
    want_plain = jax_gqa(jq, jk, jv, causal=causal, q_offset=off)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, q_offset=off, impl="ref", block_q=64, block_k=64)
    got_auto = flash_attention(q, k, v, causal=causal, q_offset=off, block_q=64, block_k=64)
    got_naive = naive_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert flash_attention.launches == before  # CPU tensors: the plain versions only
    assert got.dtype == q.dtype and got.shape == (b, sq, hq, dh)
    assert torch.equal(got, got_auto)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **tol)
    np.testing.assert_allclose(_np(got_naive), _np(want_plain), **tol)
    np.testing.assert_allclose(_np(got), _np(got_naive), **tol)


@pytest.mark.parametrize("block", [64, 128])
def test_skip_masked_blocks_matches_jax_ref(block):
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 300, 300, 4, 2, 32, seed=2), "f32")
    want = jax_flash_ref(jq, jk, jv, causal=True, block_q=block, block_k=64, skip_masked_blocks=True)
    got = flash_attention(q, k, v, causal=True, impl="ref", block_q=block, block_k=64,
                          skip_masked_blocks=True)
    unskipped = flash_attention_ref(q, k, v, causal=True, block_q=block, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got), _np(unskipped), **TOL)


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 37)])
def test_kv_valid_len_matches_jax(causal, q_offset):
    """Decode masking: a few query rows over a cache of which only a prefix
    per batch row is valid."""
    sq = 1 if not causal else 3
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, sq, 48, 4, 2, 64, seed=3), "f32")
    valid = np.array([7, 40], np.int32)
    want_ref = jax_flash_ref(jq, jk, jv, causal=causal, q_offset=q_offset,
                             kv_valid_len=jnp.asarray(valid), block_q=16, block_k=16)
    want_plain = jax_gqa(jq, jk, jv, causal=causal, q_offset=q_offset, kv_valid_len=jnp.asarray(valid))
    tv = torch.from_numpy(valid)
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=tv,
                          impl="ref", block_q=16, block_k=16)
    got_naive = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=tv, impl="naive")
    np.testing.assert_allclose(_np(got), _np(want_ref), **TOL)
    np.testing.assert_allclose(_np(got_naive), _np(want_plain), **TOL)
    # rows past the valid prefix do not matter
    k2, v2 = k.clone(), v.clone()
    k2[0, 7:], v2[1, 40:] = 1e3, -1e3
    again = flash_attention(q, k2, v2, causal=causal, q_offset=q_offset, kv_valid_len=tv,
                            impl="ref", block_q=16, block_k=16)
    assert torch.equal(got, again)


def test_cuda_route_refuses_kv_valid_len_and_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 1, 32))
    before = flash_attention.launches
    with pytest.raises(NotImplementedError, match="kv_valid_len"):
        flash_attention(q, k, v, kv_valid_len=torch.tensor([4]), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, k, v, impl="pallas")
    assert flash_attention.launches == before


def test_launch_count_is_a_plain_integer():
    assert isinstance(flash_attention.launches, int)
