"""Megatron TP and FSDP training of the dense transformer on the port's
("data", "model") engine mesh (`models.dense_mesh`) against the JAX package,
on the same seeded numpy inputs, in float32.

* `TransformerConfig.rules`, `param_specs` and `kv_cache_specs` equal the
  reference's for llama3.2-3b, yi-34b, olmoe-1b-7b and the smoke llama, under
  both strategies, with and without `multi_pod`, on `test_torch_mesh2d.py`'s
  stand-in meshes and without a mesh;
* the loss (within 1e-6 relative), the logits (1e-5 of the largest) and every
  gradient (1e-5 of its largest entry) against `jax.value_and_grad` of
  `repro.models.transformer.loss_fn` on the whole params, with the weights
  carried across by `interop.transformer_params`: the reference's 2 × 2 test
  shape (2 layers, d 64, 4 heads, 2 KV heads, d_ff 128, vocab 128), the
  recompute on, on stacked meshes (1, 4), (2, 2) and (2, 4) under "tp_sp" and
  "fsdp" ((1, 4) and (2, 4) split 2 KV heads over 4 engines: the head-gather
  path), and a vocab of 130 (whole on 4 model engines) with a `valid` mask;
* one AdamW step on the laid-out tree: the leaves keep their layout (updated
  in place), and put back whole they equal the step on the whole tree within
  1e-6 where the gradient is above 1e-5 or 0 (as `test_torch_lm_gnn_train.py`
  compares steps, at 1e-6), within 2·lr elsewhere; the global norm of leaves
  split over two axes and over the flattened pair equals the whole tree's;
* the vocab-parallel embedding bit-equal to the plain gather; whole params
  refused on a mesh;
* one gloo run (4 spawned ranks on a 2 × 2 mesh, a permutation that is not
  the identity, `tests/_torch_mesh_runs.py`'s `dense_tp_train` job): the
  gradients and the params after one AdamW step bit-equal to stacked under
  "tp_sp" (heads on their engines, and with one KV head the head-gather path)
  and "fsdp" (a `valid` mask).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, MESH_2D, WORLD, dense_tp_config, engine_block, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import sharding as jsh
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_mesh
from repro_torch.models import dense_mesh
from repro_torch.models import sharding as sh
from repro_torch.models import transformer as tfm
from repro_torch.train import optim
from repro_torch.train.loop import make_train_step
from repro_torch.train.pytree import tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16},
          "odd": {"data": 3, "model": 5}}
STRATEGIES = [(False, "tp_sp"), (False, "fsdp"), (True, "tp_sp"), (True, "fsdp")]
LOSS_RTOL = 1e-6
GRAD_REL = 1e-5
LOGITS_REL = 1e-5
STEP_TOL = 1e-6
STEP_LR = 1e-3  # the reference launcher's lr
STEP_GRAD_FLOOR = 1e-5  # at |g| ≥ 1e-5 Adam's first step moves at most lr·eps/g² = 0.1× a change in g
AXES = ("data", "model")


def _flat(tree):
    return {k: _flat(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-34b", "olmoe-1b-7b", "smoke"])
@pytest.mark.parametrize("multi_pod,strategy", STRATEGIES)
def test_param_and_kv_cache_specs_equal_the_reference(arch, multi_pod, strategy):
    name = "llama3.2-3b" if arch == "smoke" else arch
    if arch == "smoke":
        cfg, jcfg = get_arch(name).smoke_config(), jax_get_arch(name).smoke_config()
    else:
        cfg, jcfg = get_arch(name).model_config(), jax_get_arch(name).model_config(dryrun=False)
    cfg = dataclasses.replace(cfg, rules=sh.MeshRules(multi_pod, strategy))
    jcfg = dataclasses.replace(jcfg, rules=jsh.MeshRules(multi_pod, strategy))
    assert tfm.TransformerConfig("t", 1, 8, 2, 1, 16, 32).rules == sh.MeshRules()
    for shape in (*MESHES.values(), None):
        m = None if shape is None else types.SimpleNamespace(shape=shape)
        got, want = tfm.param_specs(cfg, m), jtfm.param_specs(jcfg, m)
        assert _flat(got) == _flat(want), (shape, _flat(got), _flat(want))
        assert isinstance(got["layers"]["wq"], sh.P)
        assert _flat(tfm.kv_cache_specs(cfg, m)) == _flat(jtfm.kv_cache_specs(jcfg, m)), shape


def _jax_pair(vocab: int):
    """The reference's 2 × 2 test shape at `vocab`: the JAX config and
    weights, and the port's config (to be given rules) and the same weights."""
    jcfg = jtfm.TransformerConfig("t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=vocab,
                                  dtype=jnp.float32)
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    cfg = dense_tp_config("tp_sp", vocab=vocab)
    return jcfg, jp, cfg, interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batch(vocab: int, valid: bool) -> dict:
    rng = np.random.default_rng(vocab)
    toks = rng.integers(0, vocab, (8, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if valid:
        batch["valid"] = rng.random((8, 16)) < 0.7
    return batch


@functools.lru_cache(maxsize=None)
def _reference(vocab: int, valid: bool):
    """jax.value_and_grad of the reference's loss on the whole params, and its
    logits: (loss, {path: grad}, logits)."""
    jcfg, jp, _, _ = _jax_pair(vocab)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(vocab, valid).items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda q: jtfm.loss_fn(q, jbatch, jcfg)))(jp)
    logits = jax.jit(lambda q: jtfm.forward(q, jbatch["tokens"], jcfg))(jp)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    return float(loss), flat, np.asarray(logits)


def _laid_out(params: dict, cfg, mesh) -> dict:
    sharded = tfm.shard_params(params, cfg, mesh)
    for t in tree_leaves(sharded):
        t.requires_grad_(True)
    return sharded


# (mesh, strategy, vocab, valid mask): the test shape on every mesh; 130 does not divide over 4 model engines
GRAD_CASES = [(shape, strategy, 128, False) for shape in ((1, 4), (2, 2), (2, 4)) for strategy in ("tp_sp", "fsdp")]
GRAD_CASES += [((2, 4), strategy, 130, True) for strategy in ("tp_sp", "fsdp")]


@pytest.mark.parametrize("shape,strategy,vocab,valid", GRAD_CASES)
def test_loss_logits_and_grads_match_jax_grad_of_the_unsharded_reference(shape, strategy, vocab, valid):
    _, _, cfg, p = _jax_pair(vocab)
    cfg = dataclasses.replace(cfg, rules=sh.MeshRules(strategy=strategy))
    mesh = make_mesh(shape, AXES, device="cpu")
    specs = tfm.param_specs(cfg, mesh)
    assert cfg.remat
    if strategy == "tp_sp":
        assert tuple(specs["embed"])[0] == (None if vocab % shape[1] else "model")
    batch = _batch(vocab, valid)
    want_loss, want_grads, want_logits = _reference(vocab, valid)
    sharded = _laid_out(p, cfg, mesh)
    loss = tfm.loss_fn(sharded, batch, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, tree_leaves(sharded))
    assert loss.shape == () and abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    whole = tfm.unshard_params(tree_unflatten(sharded, grads), cfg, mesh)
    got = {"/".join(path): g.numpy() for path, g in tree_leaves_with_path(whole)}
    assert set(got) == set(want_grads)
    for k, w in want_grads.items():
        assert got[k].shape == w.shape, k
        assert float(np.abs(got[k] - w).max()) <= GRAD_REL * float(np.abs(w).max()), k
    with torch.no_grad():
        logits = tfm.forward(sharded, batch["tokens"], cfg, mesh=mesh).numpy()
    assert logits.shape == want_logits.shape
    assert float(np.abs(logits - want_logits).max()) <= LOGITS_REL * float(np.abs(want_logits).max())


@pytest.mark.parametrize("strategy", ["tp_sp", "fsdp"])
def test_one_adamw_step_keeps_the_layout_and_equals_the_whole_trees(strategy):
    """Compared where the whole tree's gradient is above STEP_GRAD_FLOOR or
    exactly 0: Adam's first step moves an entry by about ±lr whatever its
    size, so a gradient at the rounding noise may move it either way (by at
    most 2·lr, which every entry is held to)."""
    cfg = dense_tp_config(strategy)
    mesh = make_mesh((2, 4), AXES, device="cpu")
    batch = _batch(128, False)
    params = tfm.init_params(cfg, 3, device="cpu")
    opt = dict(lr=STEP_LR, max_grad_norm=1.0)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    grads = torch.autograd.grad(tfm.loss_fn(tree_unflatten(params, leaves), batch, cfg), leaves)
    init, step = make_train_step(lambda q, b: tfm.loss_fn(q, b, cfg), optim.adamw(**opt))
    whole, _ = step(init(tree_map(torch.clone, params)), batch)
    laid = tfm.shard_params(params, cfg, mesh)
    before = {path: (t.shape, t.data_ptr()) for path, t in tree_leaves_with_path(laid)}
    init, step = make_train_step(lambda q, b: tfm.loss_fn(q, b, cfg, mesh=mesh),
                                 optim.adamw(**opt, mesh=mesh, sharded=tfm.sharded_specs(cfg, mesh)))
    state, _ = step(init(laid), batch)
    assert {path: (t.shape, t.data_ptr()) for path, t in tree_leaves_with_path(state.params)} == before
    got = tfm.unshard_params(tree_map(lambda t: t.detach(), state.params), cfg, mesh)
    compared = 0
    for (path, g), w, gw in zip(tree_leaves_with_path(got), tree_leaves(whole.params), grads):
        diff = (g - w.detach()).abs()
        above = (gw.abs() > STEP_GRAD_FLOOR) | (gw == 0)
        assert float(diff[above].max()) <= STEP_TOL, path
        assert float(diff.max()) <= 2 * STEP_LR, path
        compared += int(above.sum())
    assert compared >= 0.99 * sum(t.numel() for t in grads)


@pytest.mark.parametrize("strategy", ["tp_sp", "fsdp"])
def test_global_norm_of_leaves_split_over_two_axes_and_the_flattened_pair(strategy):
    cfg = dense_tp_config(strategy)
    mesh = make_mesh((2, 4), AXES, device="cpu")
    grads = tfm.init_params(cfg, 5, device="cpu")
    specs = tfm.sharded_specs(cfg, mesh)
    want_spec = {"tp_sp": (None, "data", "model"), "fsdp": (None, ("data", "model"), None)}[strategy]
    assert tuple(specs[("layers", "wq")]) == want_spec
    laid = tfm.shard_params(grads, cfg, mesh)
    _, norm = optim.clip_by_global_norm(tree_map(torch.clone, laid), 1e9, mesh=mesh, sharded=specs)
    _, want = optim.clip_by_global_norm(tree_map(torch.clone, grads), 1e9)
    assert abs(float(norm) - float(want)) <= 1e-6 * float(want)


def test_vocab_parallel_embedding_is_bit_equal_to_the_gather():
    cfg = dense_tp_config("tp_sp", vocab=256)
    params = tfm.init_params(cfg, 7, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (8, 16)))
    want = tfm._embed(params, toks, cfg)
    for shape in ((2, 4), (1, 8)):
        mesh = make_mesh(shape, AXES, device="cpu")
        specs = tfm.param_specs(cfg, mesh)
        assert tuple(specs["embed"]) == ("model", "data")
        plan = dense_mesh._plan(cfg, mesh, specs, len(toks))
        table = tfm.shard_params(params, cfg, mesh)["embed"]
        got = dense_mesh._embed(cfg, plan, table, dense_mesh._rows(plan, toks), frozenset(plan.batch))
        whole = sh.unshard_tensor(got, sh.P(plan.batch, None, None), mesh)
        assert got.shape[:2] == (shape[0], 1) and torch.equal(whole, want), shape


def test_a_dense_model_on_a_mesh_refuses_whole_params():
    cfg = dense_tp_config("tp_sp")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    batch = _batch(128, False)
    with pytest.raises(ValueError, match="laid out on it"):
        tfm.forward(params, batch["tokens"], cfg, mesh=mesh)
    with pytest.raises(ValueError, match="laid out on it"):
        tfm.loss_fn(params, batch, cfg, mesh=mesh)
    laid = tfm.shard_params(params, cfg, mesh)
    assert laid["layers"]["wq"].shape == (2, 2, 2, 32, 32)  # (data, model, L, d / 2, H·dh / 2)
    assert laid["layers"]["attn_norm"].shape == (1, 1, 2, 64)
    assert laid["layers"]["wq"].movedim(2, 0).is_contiguous()  # layer-major
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tfm.unshard_params(laid, cfg, mesh)), tree_leaves(params)))


def test_gloo_2x2_training_step_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("dense_tp_train", tmp_path)
    want = JOBS["dense_tp_train"](make_job_mesh("dense_tp_train", "stacked"))
    assert {k.split("/")[0] for k in want if k != "engines"} == {"tp_sp", "tp_sp_gather", "fsdp"}
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        (e,) = got["engines"].tolist()
        for k, v in want.items():
            if k == "engines":
                continue
            w = v if k.endswith("/loss") else engine_block(v, e, MESH_2D[0])
            assert got[k].shape == w.shape and np.array_equal(got[k], w), (r, k)
    assert sorted(int(got["engines"][0]) for got in ranks) == list(range(WORLD))
    assert not torch.distributed.is_initialized()
