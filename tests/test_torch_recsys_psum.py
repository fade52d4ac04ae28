"""dcn-v2's sharded lookup (`lookup_impl="psum_model"`) against the JAX
package's gather lookup on the same weights and ids.

The tables are laid out row-sharded on a stacked `make_mesh` by
`sharding.shard_tensor(tables, recsys.param_specs(cfg, mesh)["tables"],
mesh)`.  The lookup is bit-equal to the reference's `embedding_lookup`
(gather) for single-hot ids, ids outside [0, V) included (each id sits in one
shard and the others add exactly 0), and within 1e-6 for weighted
multi-hot bags (the same products summed in another order: a shard's bag,
then the fold over "model"); on meshes (2, 4), (1, 4), (2, 2) and (4, 2)
with batches that divide the data axis and batches that do not.  The loss
and every gradient, the tables' unsharded by `unshard_tensor`, against
`jax.grad` of the reference's `loss_fn`; one bag launch a data row a lookup; the
`ValueError` on rows that do not divide the model axis; the refusal without
a mesh; and a gloo run of 4 ranks on a 2 × 2 mesh bit-equal to stacked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import recsys as jrec
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_engines_mesh, make_mesh
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models import recsys as rec
from repro_torch.models.sharding import shard_tensor, unshard_tensor

MULTI_HOT_ATOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)  # float32 sums of the same terms in another order
SHAPES = [(2, 4), (1, 4), (2, 2), (4, 2)]


def _cfgs(multi_hot=1, rows=64):
    kw = dict(rows_per_table=rows, n_sparse=3, n_dense=2, mlp_dims=(16,), multi_hot=multi_hot)
    return jrec.DcnConfig(**kw), rec.DcnConfig(**kw, lookup_impl="psum_model")


def _ids(cfg, b, seed, *, weighted=False, outside=True):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_sparse) if cfg.multi_hot == 1 else (b, cfg.n_sparse, cfg.multi_hot)
    lo, hi = (-2, cfg.rows_per_table + 2) if outside else (0, cfg.rows_per_table)
    ids = rng.integers(lo, hi, shape).astype(np.int32)
    return ids, (rng.random(shape).astype(np.float32) if weighted else None)


def _slab(cfg, tables, mesh):
    return shard_tensor(torch.from_numpy(tables), rec.param_specs(cfg, mesh)["tables"], mesh)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [8, 7])
def test_single_hot_is_bit_equal_to_the_reference_gather(shape, b):
    jcfg, cfg = _cfgs()
    tables = np.random.default_rng(0).standard_normal((3, 64, 16)).astype(np.float32)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    slab = _slab(cfg, tables, mesh)
    assert slab.shape == (1, shape[1], 3, 64 // shape[1], 16)
    ids, _ = _ids(cfg, b, seed=b)
    want = np.asarray(jrec.embedding_lookup(jcfg, jnp.asarray(tables), jnp.asarray(ids)))
    before = embedding_bag.launches
    got = rec.embedding_lookup(cfg, slab, torch.from_numpy(ids), mesh=mesh).numpy()
    assert embedding_bag.launches == before  # the plain version on the CPU: no kernel launch
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_multi_hot_is_within_1e6_of_the_reference_gather(shape, weighted):
    jcfg, cfg = _cfgs(multi_hot=4)
    tables = np.random.default_rng(1).standard_normal((3, 64, 16)).astype(np.float32)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    for b in (8, 6):
        ids, w = _ids(cfg, b, seed=b + 10, weighted=weighted)
        want = np.asarray(jrec.embedding_lookup(jcfg, jnp.asarray(tables), jnp.asarray(ids),
                                                None if w is None else jnp.asarray(w)))
        got = rec.embedding_lookup(cfg, _slab(cfg, tables, mesh), torch.from_numpy(ids),
                                   None if w is None else torch.from_numpy(w), mesh=mesh).numpy()
        assert float(np.abs(got - want).max()) <= MULTI_HOT_ATOL


def test_one_bag_call_a_lookup_over_the_whole_slab(monkeypatch):
    """The lookup calls the bag once for each data row the process holds (the
    slab enters each row's lookup, so each row's gradient is its own), every
    call on the whole slab seen as (ep·T, V/ep, D) with every shard's ids
    shifted by its first row: on (2, 4) two calls of 4 rows."""
    _, cfg = _cfgs()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    calls = []

    def spy(tables, ids, weights=None, *, impl="auto"):
        calls.append((tuple(tables.shape), tuple(ids.shape), ids.dtype, weights))
        return embedding_bag(tables, ids, weights, impl=impl)

    monkeypatch.setattr(rec, "embedding_bag", spy)
    tables = np.random.default_rng(2).standard_normal((3, 64, 16)).astype(np.float32)
    ids, _ = _ids(cfg, 8, seed=2)
    rec.embedding_lookup(cfg, _slab(cfg, tables, mesh), torch.from_numpy(ids), mesh=mesh)
    assert calls == [((4 * 3, 16, 16), (4, 4 * 3, 1), torch.int32, None)] * 2


@pytest.mark.parametrize("which", ["smoke", "multi_hot4"])
def test_loss_and_unsharded_grads_match_jax_grad(which):
    if which == "smoke":
        jcfg, cfg = jax_get_arch("dcn-v2").smoke_config(), get_arch("dcn-v2").smoke_config()
    else:
        jcfg, cfg = _cfgs(multi_hot=4)
        cfg = dataclasses.replace(cfg, lookup_impl="gather")
    cfg = dataclasses.replace(cfg, lookup_impl="psum_model")
    jp = jrec.init_params(jcfg, jax.random.key(0))
    p = interop.recsys_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    spec = rec.param_specs(cfg, mesh)["tables"]
    p["tables"] = shard_tensor(p["tables"], spec, mesh)
    ids, w = _ids(cfg, 8, seed=4, weighted=cfg.multi_hot > 1, outside=False)
    rng = np.random.default_rng(5)
    batch = {"dense": rng.standard_normal((8, cfg.n_dense)).astype(np.float32), "sparse_ids": ids,
             "labels": rng.integers(0, 2, 8).astype(np.float32)}
    if w is not None:
        batch["sparse_weights"] = w
    jloss, jgrad = jax.value_and_grad(jrec.loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = [p["tables"]] + [lp[k] for lp in p["cross"] + p["mlp"] + [p["out"]] for k in sorted(lp)]
    for t in leaves:
        t.requires_grad_(True)
    loss = rec.loss_fn(p, batch, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6, atol=1e-6)
    g_tables = unshard_tensor(grads[0], spec, mesh)
    np.testing.assert_allclose(g_tables.numpy(), np.asarray(jgrad["tables"]), **GRAD_TOL)
    want = [np.asarray(lp[k]) for lp in jgrad["cross"] + jgrad["mlp"] + [jgrad["out"]] for k in sorted(lp)]
    assert len(want) == len(grads) - 1
    for g, wnt in zip(grads[1:], want):
        np.testing.assert_allclose(g.numpy(), wnt, **GRAD_TOL)
    assert grads[0].shape == p["tables"].shape  # the gradient stays in the local slab


def test_rows_that_do_not_divide_the_model_axis_raise():
    _, cfg = _cfgs(rows=66)
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    ids, _ = _ids(cfg, 4, seed=0)
    with pytest.raises(ValueError, match="must divide the model axis"):
        rec.embedding_lookup(cfg, torch.zeros((1, 4, 3, 16, 16)), torch.from_numpy(ids), mesh=mesh)
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="row-sharded on the mesh"):  # the whole table is not the slab
        rec.embedding_lookup(cfg, torch.zeros((3, 64, 16)), torch.from_numpy(ids), mesh=mesh)


def test_psum_model_needs_a_mesh_with_the_model_axis():
    _, cfg = _cfgs()
    ids, _ = _ids(cfg, 4, seed=0)
    with pytest.raises(ValueError, match="needs a mesh with the 'model' axis"):
        rec.embedding_lookup(cfg, torch.zeros((3, 64, 16)), torch.from_numpy(ids))
    with pytest.raises(ValueError, match="needs a mesh with the 'model' axis"):
        rec.embedding_lookup(cfg, torch.zeros((3, 64, 16)), torch.from_numpy(ids),
                             mesh=make_engines_mesh(num_engines=2, device="cpu"))
    with pytest.raises(ValueError, match="unknown lookup_impl"):
        rec.embedding_lookup(dataclasses.replace(cfg, lookup_impl="psum"), torch.zeros((3, 64, 16)),
                             torch.from_numpy(ids))


def test_gloo_2x2_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("recsys_psum", tmp_path)
    want = JOBS["recsys_psum"](make_job_mesh("recsys_psum", "stacked"))
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and np.array_equal(got[k], v), (r, k)
    assert not torch.distributed.is_initialized()
