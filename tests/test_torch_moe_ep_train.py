"""Training through `repro_torch.models.moe`'s expert parallelism
(impl="ep_shardmap") against the JAX package on the same seeded numpy
inputs, in float32.

* EP's gradients with respect to the tokens, the router, the expert stacks
  (laid out on the mesh by `moe.shard_experts`, put back whole by
  `unshard_experts`) and the shared expert against `jax.grad` of the
  reference's per-device body under nested `jax.vmap` (the harness of
  `tests/test_torch_moe_ep.py`), at capacity_factor 1.25 (slots drop) and
  4.0, on meshes (1, 4), (2, 2) and (2, 4), with 6 experts padded to 8, with
  and without the shared expert: each within 1e-4 of its largest entry (the
  forward is within the reference's own 2e-5; the engines' partial
  gradients of the router and the slab are summed in another order);
* the smoke qwen2-moe-a2.7b (a shared expert) with EP on (2, 2), every leaf
  laid out (Megatron TP attention and shared expert, EP experts), the
  recompute on, at capacity_factor 4.0 (nothing drops): the loss within
  1e-5 relative and every gradient within 1e-4 of its largest entry against
  `jax.grad` of the reference's loss (whose forward, with no mesh, runs the
  local path: the same function);
* `moe_block.ep_log` holds one entry a layer a forward under the recompute;
* one AdamW step over gloo (4 spawned ranks on a 2 × 2 mesh, a permutation
  that is not the identity) and on the stacked mesh, every leaf laid out
  (TP attention, EP experts): every gradient and every updated weight
  bit-equal, a rank holding its own block of each leaf (the whole of a
  replicated one); and an EP block of 5 experts
  (padded to 6) with a shared expert at 1.25, its gradients with respect to
  its weights and tokens bit-equal the same way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, MESH_2D, WORLD, engine_block, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.train.pytree import tree_leaves, tree_unflatten
from test_torch_moe_ep import _case, _reference_ep

GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
TRANSFORMER_GRAD_REL = 1e-4


def _assert_rel(got: np.ndarray, want: np.ndarray, rel: float, what):
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max()), what


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("shared", [False, True])
def test_ep_grads_match_jax_grad_of_the_reference_per_device_body(shape, cf, shared, monkeypatch):
    jm, m, lp, x = _case(shared=shared, cf=cf, seed=shape[0] * 10 + shape[1])
    dy = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jnp_lp = {k: jnp.asarray(v) for k, v in lp.items()}
    _reference_ep(jm, lp, x, shape, monkeypatch)  # routes jmoe's EP through the vmapped per-device body

    def jloss(p, xx):
        return jnp.sum(jmoe.moe_block(jm, p, xx) * dy)

    jg_lp, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp_lp, jnp.asarray(x))
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    whole = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_block(m, moe.shard_experts(m, whole, mesh), xt, mesh=mesh)
    names = sorted(whole)
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), [xt] + [whole[k] for k in names])
    _assert_rel(grads[0].numpy(), np.asarray(jg_x), GRAD_REL, "x")
    for k, g in zip(names, grads[1:]):
        _assert_rel(g.numpy(), np.asarray(jg_lp[k]), GRAD_REL, k)


def test_the_laid_out_stacks_carry_the_gradient_of_their_own_experts():
    """The gradient with respect to the laid-out slab is the whole stacks'
    gradient laid out the same way (the padded experts' rows zero), and EP
    refuses the whole stacks."""
    jm, m, lp, x = _case(shared=True, cf=1.25, seed=2)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    whole = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    laid = {k: v.detach().requires_grad_(True) for k, v in moe.shard_experts(m, whole, mesh).items()}
    assert laid["we_gate"].shape == (1, 4, 2, 32, 48)  # (data 1, model 4, e_l = 8 / 4, D, F)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    g_laid = torch.autograd.grad((moe.moe_block(m, laid, torch.from_numpy(x), mesh=mesh) * dy).sum(),
                                 [laid[k] for k in moe.EXPERT_KEYS])
    g_whole = torch.autograd.grad((moe.moe_block(m, moe.shard_experts(m, whole, mesh), torch.from_numpy(x),
                                                 mesh=mesh) * dy).sum(), [whole[k] for k in moe.EXPERT_KEYS])
    back = moe.unshard_experts(m, dict(zip(moe.EXPERT_KEYS, g_laid)), mesh)
    for k, g in zip(moe.EXPERT_KEYS, g_whole):
        assert torch.equal(back[k], g), k
        assert float(g_laid[moe.EXPERT_KEYS.index(k)][0, 3, 1].abs().max()) == 0.0  # expert 7: padding
    with pytest.raises(ValueError, match="laid out on the mesh"):
        moe.moe_block(m, whole, torch.from_numpy(x), mesh=mesh)


def _pair(arch):
    jcfg = jax_get_arch(arch).smoke_config()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=4.0))
    cfg = get_arch(arch).smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0, impl="ep_shardmap"))
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    p = interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, cfg, jp, p, batch


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b"])
def test_transformer_loss_and_grads_with_ep_match_jax_grad(arch):
    jcfg, cfg, jp, p, batch = _pair(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jtfm.loss_fn(q, jbatch, jcfg)))(jp)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    sharded = tfm.shard_params(p, cfg, mesh)
    leaves = tree_leaves(sharded)
    for t in leaves:
        t.requires_grad_(True)
    assert cfg.remat and sharded["layers"]["we_gate"].dim() == 6  # (data, model, layers, e_l, D, F)
    assert sharded["layers"]["wq"].shape[:2] == (2, 2)  # every leaf laid out: (data, model, layers, D / 2, ·)
    loss = tfm.loss_fn(sharded, batch, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    whole = tfm.unshard_params(tree_unflatten(sharded, grads), cfg, mesh)
    want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    got = [g.numpy() for g in tree_leaves(whole)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel(g, w, TRANSFORMER_GRAD_REL, i)


def test_ep_log_counts_each_layer_once_a_forward_under_the_recompute():
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    params = tfm.shard_params(tfm.init_params(cfg, 0, device="cpu"), cfg, mesh)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    moe.moe_block.ep_log = log = []
    try:
        loss = tfm.loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cfg, mesh=mesh)
        assert len(log) == cfg.n_layers
        torch.autograd.grad(loss, leaves)  # the backward recomputes every layer
    finally:
        moe.moe_block.ep_log = None
    assert cfg.remat and len(log) == cfg.n_layers
    assert all(r.stage1.shape == (4, 2) for r in log)


def test_gloo_2x2_training_step_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("moe_ep_train", tmp_path)
    want = JOBS["moe_ep_train"](make_job_mesh("moe_ep_train", "stacked"))
    shape = MESH_2D[0]
    # every leaf of the transformer laid out (TP attention, EP experts), and the block's expert stacks
    laid = [k for k in want if k.startswith(("grad/", "param/")) or k.startswith("block/grad/")
            and k.endswith(moe.EXPERT_KEYS)]
    assert len([k for k in laid if k.endswith(moe.EXPERT_KEYS)]) == 3 * 3  # the grads and updated stacks, the block's
    assert want["grad/embed"].shape[:2] == (2, 2) and want["param/layers/attn_norm"].shape[:2] == (1, 1)
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        (e,) = got["engines"].tolist()
        for k, v in want.items():
            if k == "engines":
                continue
            w = engine_block(v, e, shape) if k in laid else v
            assert got[k].shape == w.shape and np.array_equal(got[k], w), (r, k)
    assert sorted(int(got["engines"][0]) for got in ranks) == list(range(WORLD))
    assert not torch.distributed.is_initialized()
