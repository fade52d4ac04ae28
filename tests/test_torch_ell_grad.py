"""The gradient of the ELL reduce, `segment_spmm`, through its transposed ELL,
against `jax.grad` of the reference's GIN sum (`jax.ops.segment_sum` of the
gathered, masked messages, `repro.models.gnn.gin_forward`) on the same
numpy-seeded inputs.

The graph is directed R-MAT with the cases a wrong direction hides in:
multi-edges (R-MAT's own and added twins), masked edges, vertices of
in-degree 0 and of out-degree 0, and degrees far from symmetric.  The
gradient is grad_x[u] = Σ_{u→v unmasked} grad_out[v]: the reduce over
`build_ell` of the unreversed edges, which `gnn.batch_ell(...,
transpose=True)` carries as `ell.transpose`.  An ELL whose transpose is the
forward's own direction must fail the comparison.

Tolerance: float32 sums of the same terms in another order, rtol/atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.graph.generators import rmat
from repro_torch.graph.structs import HostGraph, build_ell
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.models import gnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(seed=0, n_core=60):
    """R-MAT on vertices 0..n_core-1, twins of 40 of its edges, 6 vertices
    with out-edges only, 6 with in-edges only, 2 with none; 10 % of the edges
    masked and 8 padded slots pointing at the sentinel N."""
    g = rmat(n_core, 500, seed=seed)
    rng = np.random.default_rng(seed)
    twins = rng.choice(g.num_edges, 40, replace=False)
    n = n_core + 14
    out_only = np.arange(n_core, n_core + 6)
    in_only = np.arange(n_core + 6, n_core + 12)
    src = np.concatenate([g.src, g.src[twins], np.repeat(out_only, 5), rng.integers(0, n_core, 30)])
    dst = np.concatenate([g.dst, g.dst[twins], rng.integers(0, n_core, 30), np.repeat(in_only, 5)])
    e = src.size
    mask = rng.random(e) >= 0.1
    src = np.concatenate([src, np.full(8, n)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(8, n)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(8, bool)])
    return {"x": rng.standard_normal((n, 16)).astype(np.float32), "src": src, "dst": dst, "edge_mask": mask}


def _jax_grad(batch, dy):
    n = batch["x"].shape[0]
    src, dst, m = (jnp.asarray(batch[k]) for k in ("src", "dst", "edge_mask"))

    def gin_sum(x):  # repro.models.gnn.gin_forward's aggregation
        hp = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])
        return jax.ops.segment_sum(hp[src] * m[:, None], dst, num_segments=n + 1)[:n]

    out, vjp = jax.vjp(gin_sum, jnp.asarray(batch["x"]))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(dy))[0])


def _port_grad(batch, ell, dy):
    x = torch.from_numpy(batch["x"]).requires_grad_(True)
    out = segment_spmm(x, ell)
    (g,) = torch.autograd.grad(out, x, torch.from_numpy(dy))
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_through_the_transposed_ell_matches_jax_grad(seed):
    batch = _batch(seed)
    n = batch["x"].shape[0]
    m = batch["edge_mask"]
    assert np.unique(np.stack([batch["src"][m], batch["dst"][m]]), axis=1).shape[1] < m.sum()  # multi-edges
    out_deg = np.bincount(batch["src"][m], minlength=n + 1)[:n]
    in_deg = np.bincount(batch["dst"][m], minlength=n + 1)[:n]
    assert (out_deg == 0).any() and (in_deg == 0).any() and (out_deg != in_deg).any()
    dy = np.random.default_rng(seed + 10).standard_normal((n, 16)).astype(np.float32)
    ell = gnn.batch_ell(batch, device="cpu", transpose=True)
    out, got = _port_grad(batch, ell, dy)
    want_out, want = _jax_grad(batch, dy)
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[out_deg == 0].any()  # a vertex that sends nothing gets a zero row


def test_a_transpose_in_the_forward_direction_fails_the_comparison():
    """The wrong direction, in the backward: the forward's own ELL as the transpose
    gives grad_x[v] = Σ_{u→v} grad_out[u], which the reference does not."""
    batch = _batch(0)
    n = batch["x"].shape[0]
    dy = np.random.default_rng(5).standard_normal((n, 16)).astype(np.float32)
    wrong = gnn.batch_ell(batch, device="cpu")
    wrong.transpose = gnn.batch_ell(batch, device="cpu")
    _, got = _port_grad(batch, wrong, dy)
    _, want = _jax_grad(batch, dy)
    assert not np.allclose(got, want, **TOL)


def test_weighted_graph_gradient_is_the_weighted_transpose():
    g = rmat(50, 400, seed=3, weighted=True)
    ell = build_ell(g.reversed(), device="cpu")
    ell.transpose = build_ell(g, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    (got,) = torch.autograd.grad(segment_spmm(x, ell), x, dy)
    want = np.zeros((50, 8), np.float32)
    np.add.at(want, g.src, g.weight[:, None] * dy.numpy()[g.dst])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_refusals_and_the_routes_without_a_gradient():
    batch = _batch(0)
    x = torch.from_numpy(batch["x"])
    ell = gnn.batch_ell(batch, device="cpu")
    with pytest.raises(ValueError, match="no transpose"):
        segment_spmm(x.clone().requires_grad_(True), ell)
    # no gradient asked for: no transpose needed
    assert not segment_spmm(x, ell).requires_grad
    with torch.no_grad():
        assert segment_spmm(x.clone().requires_grad_(True), ell).shape == x.shape
    # the plain route stays differentiable by autograd, transpose or not
    assert segment_spmm(x.clone().requires_grad_(True), ell, impl="ref").requires_grad
    g = HostGraph(4, np.array([0, 1, 2]), np.array([1, 2, 3]), np.ones(3, np.float32))
    weighted = build_ell(g.reversed(), device="cpu")
    weighted.transpose = build_ell(g, device="cpu")
    for w in weighted.weights:
        w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="edge weight"):
        segment_spmm(torch.ones((4, 2)), weighted)
    with pytest.raises(ValueError, match="CUDA"):
        segment_spmm(x, ell, impl="cuda")
