"""Training dcn-v2 with the sharded lookup (`lookup_impl="psum_model"`) on
an engine mesh.

* One AdamW step over gloo (4 spawned ranks on a 2 × 2 mesh, a permutation
  that is not the identity) and on the stacked mesh, on a batch split over
  the data axis: every gradient and every updated weight bit-equal, a rank
  holding its own block of the tables (laid out over "model": its
  process_group layout, (1, 1, T, V/2, D)) and the whole of every other
  leaf; and the gradients of a batch of 5, which does not split over the
  data axis (every data row then looks the whole batch up, and the tables
  do not enter the lookup once a row), bit-equal the same way.
* The loss and the unsharded gradients of such an unsplit batch against
  `jax.grad` of the reference's `loss_fn` (the split batch's are in
  `tests/test_torch_recsys_psum.py`): the loss within 1e-6, gradients
  within 1e-5 relative and 1e-6 absolute (float32 sums of the same terms in
  another order).
* The global norm of the optimizer's clip on the mesh counts each block of a
  laid-out leaf once: within 1e-6 relative of the norm of the unsharded
  gradients, and exactly the one-device norm for leaves held whole.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_mesh_runs import JOBS, MESH_2D, WORLD, engine_block, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import recsys as jrec
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_mesh
from repro_torch.models import recsys as rec
from repro_torch.models.sharding import shard_tensor, unshard_tensor
from repro_torch.train.optim import clip_by_global_norm
from repro_torch.train.pytree import tree_leaves, tree_map, tree_unflatten

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
NORM_RTOL = 1e-6


def _pair():
    jcfg = jax_get_arch("dcn-v2").smoke_config()
    cfg = dataclasses.replace(get_arch("dcn-v2").smoke_config(), lookup_impl="psum_model")
    jp = jrec.init_params(jcfg, jax.random.key(0))
    return jcfg, cfg, jp, interop.recsys_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
            "sparse_ids": rng.integers(0, cfg.rows_per_table, (b, cfg.n_sparse)).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.float32)}


def _laid_out_grads(p, cfg, batch, mesh):
    spec = rec.param_specs(cfg, mesh)["tables"]
    laid = dict(p, tables=shard_tensor(p["tables"], spec, mesh))
    leaves = tree_leaves(laid)
    for t in leaves:
        t.requires_grad_(True)
    loss = rec.loss_fn(laid, batch, cfg, mesh=mesh)
    return loss, tree_unflatten(laid, torch.autograd.grad(loss, leaves)), spec


def test_grads_of_a_batch_that_does_not_split_over_data_match_jax_grad():
    jcfg, cfg, jp, p = _pair()
    batch = _batch(cfg, 6, seed=3)  # 6 rows on 4 data rows: the whole batch on every data row
    jloss, jgrad = jax.value_and_grad(jrec.loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    loss, grads, spec = _laid_out_grads(p, cfg, batch, mesh)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6, atol=1e-6)
    assert grads["tables"].shape == (1, 2, cfg.n_sparse, cfg.rows_per_table // 2, cfg.embed_dim)
    grads = dict(grads, tables=unshard_tensor(grads["tables"], spec, mesh))
    want = jax.tree.leaves(jgrad)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_the_global_norm_counts_each_block_once():
    _, cfg, _, p = _pair()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    loss, grads, spec = _laid_out_grads(p, cfg, _batch(cfg, 8, seed=4), mesh)
    whole = dict(grads, tables=unshard_tensor(grads["tables"], spec, mesh))
    _, gn = clip_by_global_norm(tree_map(torch.clone, grads), 1e9, mesh=mesh, sharded={("tables",): spec})
    _, want = clip_by_global_norm(tree_map(torch.clone, whole), 1e9)
    assert abs(float(gn) - float(want)) <= NORM_RTOL * float(want)
    rest = {k: v for k, v in grads.items() if k != "tables"}  # whole leaves count as on one device
    _, gn_rest = clip_by_global_norm(tree_map(torch.clone, rest), 1e9, mesh=mesh, sharded={})
    _, want_rest = clip_by_global_norm(tree_map(torch.clone, rest), 1e9)
    assert torch.equal(gn_rest, want_rest)


def test_gloo_2x2_training_step_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("recsys_psum_train", tmp_path)
    want = JOBS["recsys_psum_train"](make_job_mesh("recsys_psum_train", "stacked"))
    laid = {"grad/tables", "param/tables", "unsplit/grad/tables"}
    assert laid <= set(want)
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        (e,) = got["engines"].tolist()
        for k, v in want.items():
            if k == "engines":
                continue
            w = engine_block(v, e, MESH_2D[0]) if k in laid else v
            assert got[k].shape == w.shape and np.array_equal(got[k], w), (r, k)
    assert sorted(int(got["engines"][0]) for got in ranks) == list(range(WORLD))
    assert not torch.distributed.is_initialized()
