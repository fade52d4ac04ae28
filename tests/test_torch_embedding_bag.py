"""`repro_torch.kernels.embedding_bag` against `repro.kernels.embedding_bag` on
the same seeded numpy inputs: the Pallas kernel in interpret mode and the jnp
oracle for the forward, `jax.grad` through `embedding_bag(impl="ref")` (the
custom VJP `_bag_bwd`) for the gradients.  Tolerances as
`tests/test_kernels.py`: rtol 2e-3 / atol 2e-5 in float32 (fp32 sums in
another order), 1e-2 for bf16 tables (one bf16 rounding of the sum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.kernel import embedding_bag_pallas
from repro.kernels.embedding_bag.ops import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_embedding_bag_ref
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

TOL = dict(rtol=2e-3, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SHAPES = [(3, 64, 128, 4, 5), (2, 32, 16, 8, 1), (1, 100, 256, 2, 7), (4, 17, 8, 3, 2)]  # (T, V, D, B, L)


def _inputs(t, v, d, b, l, seed=0):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((t, v, d)).astype(np.float32)
    ids = rng.integers(-2, v, (b, t, l)).astype(np.int32)  # includes padding ids
    w = rng.standard_normal((b, t, l)).astype(np.float32)
    return tables, ids, w


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("T,V,D,B,L", SHAPES)
def test_forward_matches_pallas_interpret_and_oracle(T, V, D, B, L, weighted):
    tables, ids, w = _inputs(T, V, D, B, L)
    w = w if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want_pallas = np.asarray(embedding_bag_pallas(jnp.asarray(tables), jnp.asarray(ids), jw, interpret=True))
    want_ref = np.asarray(jax_embedding_bag_ref(jnp.asarray(tables), jnp.asarray(ids), jw))
    before = embedding_bag.launches
    got = embedding_bag(_t(tables), _t(ids), None if w is None else _t(w))
    assert embedding_bag.launches == before  # CPU: the plain version
    assert got.shape == (B, T, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(embedding_bag_ref(_t(tables), _t(ids), None if w is None else _t(w)).numpy(),
                               want_ref, **TOL)


def test_bf16_tables_match_pallas_interpret():
    tables, ids, w = _inputs(2, 16, 32, 3, 2, seed=2)
    tb = jnp.asarray(tables).astype(jnp.bfloat16)
    want = np.asarray(embedding_bag_pallas(tb, jnp.asarray(ids), jnp.asarray(w), interpret=True).astype(jnp.float32))
    got = embedding_bag(_t(tables).bfloat16(), _t(ids), _t(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("T,V,D,B,L", SHAPES)
def test_gradients_match_jax_custom_vjp(T, V, D, B, L):
    """d tables and d weights of Σ out·G against `jax.grad` through the
    reference's custom VJP, padding ids included."""
    tables, ids, w = _inputs(T, V, D, B, L, seed=1)
    g = np.random.default_rng(5).standard_normal((B, T, D)).astype(np.float32)

    def jloss(tab, ww):
        return (jax_embedding_bag(tab, jnp.asarray(ids), ww, impl="ref") * jnp.asarray(g)).sum()

    jt, jw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tables), jnp.asarray(w))
    tt, tw = _t(tables).requires_grad_(), _t(w).requires_grad_()
    (embedding_bag(tt, _t(ids), tw) * _t(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), **TOL)

    # the same against autograd through the plain version, inside the port
    tt2, tw2 = _t(tables).requires_grad_(), _t(w).requires_grad_()
    (embedding_bag_ref(tt2, _t(ids), tw2) * _t(g)).sum().backward()
    torch.testing.assert_close(tt.grad, tt2.grad, **TOL)
    torch.testing.assert_close(tw.grad, tw2.grad, **TOL)


def test_gradient_is_dense_and_ids_get_none():
    tables, ids, _ = _inputs(2, 32, 16, 4, 3, seed=3)
    tt = _t(tables).requires_grad_()
    out = embedding_bag(tt, _t(ids))
    (gt,) = torch.autograd.grad(out.sum(), [tt])
    assert gt.layout == torch.strided and gt.shape == tt.shape
    # unweighted: each row's gradient counts its valid occurrences
    counts = np.zeros((2, 32))
    for b in range(4):
        for t in range(2):
            for i in ids[b, t]:
                if 0 <= i < 32:
                    counts[t, i] += 1
    np.testing.assert_array_equal(gt[..., 0].numpy(), counts)


def test_routes_and_refusals_on_the_host():
    tables, ids, w = _inputs(2, 32, 16, 4, 3)
    tt, ti = _t(tables), _t(ids)
    before = embedding_bag.launches
    torch.testing.assert_close(embedding_bag(tt, ti, impl="ref"), embedding_bag(tt, ti))
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag(tt, ti, impl="cuda")  # the kernel takes CUDA tensors only
    with pytest.raises(ValueError):
        embedding_bag(tt, ti, impl="pallas")
    assert embedding_bag.launches == before
    # int64 ids are fine for the plain version
    torch.testing.assert_close(embedding_bag(tt, ti.long()), embedding_bag(tt, ti))
