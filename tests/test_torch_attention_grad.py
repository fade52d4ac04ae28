"""The attention gradient of `repro_torch`: the autograd Function of
`kernels.flash_attention.ops` on its plain route (the forward with its
log-sum-exp, the backward `flash_attention_bwd_ref` from the explicit
formulas) against `jax.grad` of the JAX package's `flash_attention(impl="ref")`
and `models.layers.gqa_attention`, on the same numpy-seeded inputs and output
cotangent: GQA (G = 1, 2, 3, 4), causal and not, ragged lengths, `q_offset`,
and rows that see no key.

Tolerance: float32 on both sides, the same function with sums in another
order: each gradient within 1e-5 of its largest magnitude.  `gradcheck` holds
the Function to finite differences in float64.

The bf16 backward kernels (`csrc/flash_attention_bwd.cu`, `wgmma`) round
more than the plain route: P and dS go to bf16 before the products that take
them.  `_kernel_bwd_emulated` repeats that arithmetic in float32 torch, and
its gradients are held within 1e-2 of each one's largest magnitude (the
tolerance the kernel is held to on the card) of `jax.grad` of the reference
in float32, on the same bf16 inputs.

Rows that see no key (causal with a negative `q_offset`) are the one place
where the two packages differ on purpose: the port's backward gives such a
row no gradient at all, while autodiff of the reference's masking (−1e30
scores, softmax over them) spreads the row's cotangent evenly over the
values it visited.  The test holds dQ and dK as they are, and dV against the
reference's with those rows' cotangent set to 0 (dV is linear in it).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

REL = 1e-5
BLOCKS = dict(block_q=8, block_k=8)

# (B, Sq, Skv, Hq, Hkv, dh, causal, q_offset)
CASES = [
    (2, 16, 16, 4, 2, 32, True, 0),
    (1, 20, 28, 6, 2, 32, True, 8),  # G = 3, ragged, kv rows past the causal edge
    (2, 12, 12, 4, 1, 32, False, 0),  # G = 4
    (1, 33, 33, 3, 3, 64, True, 0),  # G = 1, ragged blocks
    (1, 9, 23, 8, 2, 32, False, 0),
    (2, 7, 30, 6, 2, 32, True, 23),
]


def _inputs(b, sq, skv, hq, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh), (b, sq, hq, dh))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port_grads(q, k, v, do, causal, q_offset):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(*ts, causal=causal, q_offset=q_offset, **BLOCKS)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before  # the plain route
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    for g, w in zip(got, want):
        scale = float(np.abs(w).max()) + 1e-12
        assert float(np.abs(g - w).max()) <= REL * scale


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,q_offset", CASES)
def test_gradients_match_jax_grad_of_the_blocked_reference(b, sq, skv, hq, hkv, dh, causal, q_offset):
    q, k, v, do = _inputs(b, sq, skv, hq, hkv, dh)
    out, got = _port_grads(q, k, v, do, causal, q_offset)
    want_out, want = _jax_grads(
        lambda a, c, e: jax_flash_attention(a, c, e, causal=causal, q_offset=q_offset, impl="ref", **BLOCKS),
        q, k, v, do)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-6)
    _close(got, want)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,q_offset", CASES)
def test_gradients_match_jax_grad_of_gqa_attention(b, sq, skv, hq, hkv, dh, causal, q_offset):
    q, k, v, do = _inputs(b, sq, skv, hq, hkv, dh, seed=1)
    _, got = _port_grads(q, k, v, do, causal, q_offset)
    _, want = _jax_grads(lambda a, c, e: jax_gqa_attention(a, c, e, causal=causal, q_offset=q_offset), q, k, v, do)
    _close(got, want)


@pytest.mark.parametrize("q_offset", [-5, -11])
def test_rows_that_see_no_key_add_no_gradient(q_offset):
    b, sq, skv, hq, hkv, dh = 2, 16, 16, 6, 2, 32
    q, k, v, do = _inputs(b, sq, skv, hq, hkv, dh, seed=2)
    blind = -q_offset  # query rows 0 .. blind-1 see no key
    _, got = _port_grads(q, k, v, do, True, q_offset)
    assert all(np.isfinite(g).all() for g in got)
    assert not got[0][:, :blind].any()
    quiet = do.copy()
    quiet[:, :blind] = 0.0
    _, got_quiet = _port_grads(q, k, v, quiet, True, q_offset)
    np.testing.assert_array_equal(got_quiet[2], got[2])  # those rows' cotangent reaches no value
    for fn in (lambda a, c, e: jax_flash_attention(a, c, e, causal=True, q_offset=q_offset, impl="ref", **BLOCKS),
               lambda a, c, e: jax_gqa_attention(a, c, e, causal=True, q_offset=q_offset)):
        _, want = _jax_grads(fn, q, k, v, do)
        _close(got[:2], want[:2])
        _, want_quiet = _jax_grads(fn, q, k, v, quiet)
        _close(got[2:], want_quiet[2:])


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,q_offset", [
    (1, 5, 5, 2, 1, 32, True, 0), (1, 4, 7, 3, 1, 32, False, 0), (2, 3, 6, 4, 2, 32, True, 3)])
def test_gradcheck_in_float64(b, sq, skv, hq, hkv, dh, causal, q_offset):
    rng = np.random.default_rng(3)
    ts = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
          for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]
    assert torch.autograd.gradcheck(
        lambda *a: flash_attention(*a, causal=causal, q_offset=q_offset, block_q=2, block_k=4), ts)


def test_explicit_backward_is_autograd_of_the_plain_forward():
    """`flash_attention_bwd_ref` on the plain forward's output and lse equals
    autograd through the blocked plain version, in float64."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((2, 11, 6, 32), (2, 13, 2, 32), (2, 13, 2, 32)))
    out, lse = flash_attention_ref(q, k, v, causal=True, q_offset=2, block_q=4, block_k=4, return_lse=True)
    assert lse.shape == (2, 6, 11) and lse.dtype == torch.float64
    do = torch.from_numpy(rng.standard_normal(out.shape))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), do, lse, causal=True, q_offset=2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_the_function_refuses_what_it_does_not_take():
    q = torch.ones((1, 4, 2, 32), requires_grad=True)
    kv = torch.ones((1, 4, 2, 32))
    with pytest.raises(NotImplementedError, match="kv_valid_len"):
        flash_attention(q, kv, kv, kv_valid_len=torch.tensor([3]))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv, impl="cuda")
    # decode masking stays on the plain route, which autograd differentiates
    assert flash_attention(q, kv, kv, kv_valid_len=torch.tensor([3]), impl="ref").requires_grad


# ------------------------------------------------------------ the bf16 kernels' rounding

KERNEL_REL = 1e-2  # chip_smoke.py's BWD_REL["bf16"], the tolerance the bf16 kernels are held to
LOG2E = 1.4426950408889634
# narrow versions of chip_smoke.py's ATTN_BWD_TEST_SHAPES (B, Sq, Skv, Hq, Hkv, dh):
# G = 1, 3, 3, 4, 3, every head dim, lengths that are not multiples of 64
KERNEL_SHAPES = [(2, 40, 40, 4, 4, 64), (1, 24, 40, 6, 2, 32), (1, 77, 77, 6, 2, 128),
                 (1, 50, 82, 8, 2, 128), (2, 25, 23, 6, 2, 64)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _kernel_bwd_emulated(q, k, v, do, causal, q_offset):
    """The bf16 backward kernels' arithmetic in float32 on the CPU: bf16
    inputs and forward output o; fp32 S, dP, D = rowsum(dO ∘ O), P =
    2^(S·scale·log2e − lse·log2e) on the kept pairs and dS = P ∘ (dP − D);
    P and dS rounded to bf16 before dV = Pᵀ·dO, dK = scale·dSᵀ·Q and dQ =
    scale·dS·K, which sum in fp32; the gradients rounded to bf16."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)

    def heads(t):  # (B, Sq, Hq, dh) → (B, Hkv, G, Sq, dh)
        return t.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4)

    qf, df = heads(q), heads(do)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok = torch.arange(skv)[None, :] <= (torch.arange(sq) + q_offset)[:, None]
    z = torch.where(ok, s * scale, torch.tensor(-1e30))  # the forward: its lse, o in bf16
    lse = torch.logsumexp(z, -1)
    o = _bf16(torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(z, -1), vf))
    p = torch.where(ok, torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None]), torch.zeros(()))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", df, vf)
    ds = p * (dp - (df * o).sum(-1, keepdim=True))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", _bf16(p), df)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", _bf16(ds), qf) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", _bf16(ds), kf) * scale
    return [_bf16(t) for t in (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh),
                               dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))]


@pytest.mark.parametrize("causal,q_offset", [(True, None), (False, 0), (True, 37)])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh", KERNEL_SHAPES)
def test_bf16_kernel_rounding_fits_its_tolerance(b, sq, skv, hq, hkv, dh, causal, q_offset):
    """The emulated bf16 kernels against `jax.grad` of the reference's
    flash_attention(impl="ref") in float32 on the same bf16 inputs: each
    gradient within KERNEL_REL of its largest magnitude.  q_offset None is
    Skv − Sq (the causal edge at the last key); where that is negative, the
    rows that see no key get a zero cotangent, as in
    `test_rows_that_see_no_key_add_no_gradient`."""
    off = skv - sq if q_offset is None else q_offset
    q, k, v, do = (_bf16(torch.from_numpy(a)).numpy() for a in _inputs(b, sq, skv, hq, hkv, dh, seed=5))
    if causal and off < 0:
        do[:, :-off] = 0.0
    got = _kernel_bwd_emulated(*(torch.from_numpy(a) for a in (q, k, v, do)), causal, off)
    _, want = _jax_grads(lambda a, c, e: jax_flash_attention(a, c, e, causal=causal, q_offset=off, impl="ref"),
                         q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= KERNEL_REL * scale, (name, err, scale)
        assert err > 0  # the emulation rounds: it is not the reference itself
