"""Training the halo GIN (`repro_torch.models.gnn_dist`) against the JAX
package on the same seeded graph, features and weights (`interop.gnn_params`).

* The loss and every gradient of `gin_halo_loss_fn` on P = 1 and 4 stacked
  engines against `jax.grad` of the reference's global `gnn.loss_fn` over
  the whole graph, and on one engine against `jax.grad` of the reference's
  `gnn_dist.gin_halo_loss_fn` on its one-device mesh: the loss within 1e-5
  relative, each gradient within 1e-4 of its largest entry (float32, the
  neighbour sums and the engines' partial weight gradients added in another
  order, through 3 layers with LayerNorm);
* `halo_extend`'s backward against its plain transpose (the exchange's swap,
  then each sent row's cotangent added into its row, peer after peer),
  bit for bit;
* one AdamW step over gloo (4 spawned ranks, engine p on rank [2, 0, 3, 1][p])
  and on the stacked mesh: every gradient and every updated weight bit-equal
  (each weight is whole on every engine: the engines' partial gradients are
  summed once, in engine order, on both backends).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_mesh_runs import JOBS, WORLD, make_job_mesh, run_gloo
from repro.graph.generators import rmat as jrmat
from repro.graph.halo import build_halo_plan as jbuild_halo_plan
from repro.models import gnn as jgnn
from repro.models import gnn_dist as jgnn_dist
from repro_torch import interop
from repro_torch.graph.distributed import make_engines_mesh
from repro_torch.graph.halo import build_halo_plan, halo_extend
from repro_torch.models import gnn
from repro_torch.models.gnn_dist import gin_halo_loss_fn, pack_batch, shard_batch
from repro_torch.train.pytree import tree_leaves

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4  # each gradient against its largest magnitude


def _case():
    g = jrmat(120, 900, seed=4)
    jcfg = jgnn.GnnConfig("gin", "gin", n_layers=3, d_hidden=16, d_in=8, d_out=5)
    cfg = gnn.GnnConfig("gin", "gin", n_layers=3, d_hidden=16, d_in=8, d_out=5)
    jp = jgnn.init_params(jcfg, jax.random.key(0))
    params = interop.gnn_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    labels, train = rng.integers(0, 5, 120).astype(np.int32), rng.random(120) < 0.6
    return g, jcfg, cfg, jp, params, x, labels, train


def _grads(params, cfg, batch, mesh):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = gin_halo_loss_fn(params, batch, cfg, mesh)
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _assert_close(loss, grads, jloss, jgrads):
    assert np.isfinite(loss) and abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= GRAD_REL * float(np.abs(w).max())


@pytest.mark.parametrize("parts", [1, 4])
def test_loss_and_grads_match_jax_grad_of_the_global_loss(parts):
    g, jcfg, cfg, jp, params, x, labels, train = _case()
    jbatch = dict(x=jnp.asarray(x), src=jnp.asarray(g.src.astype(np.int32)), dst=jnp.asarray(g.dst.astype(np.int32)),
                  edge_mask=jnp.ones(g.num_edges, bool), node_mask=jnp.ones(120, bool), labels=jnp.asarray(labels),
                  train_mask=jnp.asarray(train))
    jloss, jgrads = jax.value_and_grad(lambda p: jgnn.loss_fn(p, jbatch, jcfg))(jp)
    mesh = make_engines_mesh(num_engines=parts, device="cpu")
    batch = shard_batch(pack_batch(build_halo_plan(g.src, g.dst, 120, parts), x, labels, train), mesh,
                        transpose=True)
    _assert_close(*_grads(params, cfg, batch, mesh), jloss, jgrads)


def test_one_engine_matches_jax_grad_of_the_reference_halo_loss():
    g, jcfg, cfg, jp, params, x, labels, train = _case()
    jbatch = {k: jnp.asarray(v) for k, v in jgnn_dist.pack_batch(jbuild_halo_plan(g.src, g.dst, 120, 1), x, labels,
                                                                  train).items()}
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("engines",))
    with jax.set_mesh(jmesh):
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jgnn_dist.gin_halo_loss_fn(p, b, jcfg, jmesh)))(jp, jbatch)
    mesh = make_engines_mesh(device="cpu")
    batch = shard_batch(pack_batch(build_halo_plan(g.src, g.dst, 120, 1), x, labels, train), mesh, transpose=True)
    _assert_close(*_grads(params, cfg, batch, mesh), jloss, jgrads)


def test_halo_extend_backward_is_its_plain_transpose_bit_for_bit():
    g = jrmat(120, 900, seed=4)
    plan = build_halo_plan(g.src, g.dst, 120, 4)
    mesh = make_engines_mesh(num_engines=4, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, plan.n_local, 6)).astype(np.float32)).requires_grad_(True)
    send_idx = torch.from_numpy(plan.send_idx.astype(np.int64))
    ext = halo_extend(x, send_idx, mesh)
    cot = rng.standard_normal(ext.shape).astype(np.float32)
    (got,) = torch.autograd.grad(ext, x, torch.from_numpy(cot))
    # the plain transpose: the local rows' cotangent, plus each sent row's, peer after peer; the exchange
    # delivered engine q's block for peer p to p's halo block q, so q's send block p is p's halo block q
    halo = cot[:, plan.n_local:].reshape(4, 4, plan.h_pair, 6)
    want = np.zeros((4, plan.n_local + 1, 6), np.float32)
    for q in range(4):
        for p in range(4):
            for h in range(plan.h_pair):
                want[q, plan.send_idx[q, p, h]] += halo[p, q, h]
    want = want[:, :plan.n_local] + cot[:, :plan.n_local]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0 and (plan.send_idx < plan.n_local).sum() > 0


def test_gloo_training_step_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("halo_train", tmp_path)
    want = JOBS["halo_train"](make_job_mesh("halo_train", "stacked"))
    keys = {k for k in want if k != "engines"}
    assert any(k.startswith("grad/") for k in keys) and any(k.startswith("param/") for k in keys)
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        for k in keys:  # every weight is whole on every rank
            assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), (r, k)
    assert sorted(int(got["engines"][0]) for got in ranks) == list(range(WORLD))
    assert not torch.distributed.is_initialized()
