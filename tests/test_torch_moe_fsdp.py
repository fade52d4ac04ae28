"""MoE models on the port's ("data", "model") engine mesh under
`MeshRules(strategy="fsdp")` (`models.dense_mesh` with `_moe_ffn`), against
the JAX package on the same seeded numpy inputs, in float32.  Every leaf is
laid out ZeRO-3 by `param_specs`, the expert stacks too (the real experts
whole, d_model over ("data", "model")), and gathered into EP's slab at use
(`moe.zero3_expert_slabs`); the token rows split over both axes, and each
engine routes its own (`moe.moe_ep_rows`).

* (a) `param_specs` and `sharded_specs` of the smoke olmoe-1b-7b and
  qwen2-moe-a2.7b under "fsdp" on (2, 2) and (2, 4) equal the reference's
  PartitionSpecs (the expert stacks by `layer_specs`, not EP's slab), and
  `shard_params` → `unshard_params` is the identity with the real expert
  count.
* (b) The composed MoE FFN on a residual laid out as `dense_mesh` holds it,
  against the reference's `moe_block` with its routed part from the
  per-device body under nested `jax.vmap` (`tests/test_torch_moe_ep.py`'s
  harness): within EP_TOL, the slot counts of both stages equal to
  `moe_ep_loop_ref`'s.  Rows split over both axes (each engine routes its
  own), one row held whole (the reference's padded flat layout), a decode
  batch of one row an engine; capacity_factor 1.25 and 4.0; with and without
  the shared expert; 6 experts padded to 8 on (2, 4); 8 × 50 at 1.25, where
  slots drop; on (3, 2), where d_model does not divide and the stacks stay
  whole.  Which branch of `moe_ep_rows` each layout takes.
* (c) The smoke models at capacity_factor 4.0 (nothing drops): `prefill`,
  `decode_step` and four `decode_step_batched_pos` steps over `shard_params`
  and `init_kv_cache(..., mesh=)` with 8 slots on stacked (2, 2) and (2, 4)
  (one row an engine), against the reference's same functions on whole
  params (MODEL_TOL) and the port's one-device impl="local" run (logits and
  cache within 1e-5 of their largest entry).
* (d) `loss_fn` and every gradient of both smoke models on (2, 2) against
  `jax.grad` of the reference's loss (`tests/test_torch_moe_ep_train.py`'s
  bounds), on a batch whose rows split over both axes and one whose rows do
  not; one AdamW step (`adamw(mesh=, sharded=sharded_specs)`) against the
  reference's.
* (e) `launch.serve.build_engine(..., mesh=)` under "fsdp" serves the tokens
  served without a mesh.
* (f) One gloo run (4 spawned ranks on 2 × 2, a permutation that is not the
  identity, `tests/_torch_mesh_runs.py`'s `moe_fsdp` job): serving logits,
  each rank's cache blocks, one training step's laid-out gradients and
  updated params, and an MoE FFN whose d_model does not divide (whole
  stacks) with its gradients, bit-equal to stacked.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, MESH_2D, TRAIN_LR, WORLD, engine_block, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import layers as jlayers
from repro.models import sharding as jsh
from repro.models import transformer as jtfm
from repro.train import loop as jloop
from repro.train import optim as jopt
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_mesh
from repro_torch.launch.serve import build_engine
from repro_torch.models import dense_mesh, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm
from repro_torch.models.sharding import P, MeshRules, shard_tensor, unshard_tensor
from repro_torch.serve.engine import Request
from repro_torch.train import optim
from repro_torch.train.loop import make_train_step
from repro_torch.train.pytree import tree_leaves, tree_map, tree_unflatten
from test_torch_moe_ep import D, EP_TOL, MODEL_TOL, _case, _reference_ep
from test_torch_moe_ep_train import LOSS_RTOL, TRANSFORMER_GRAD_REL

AXES = ("data", "model")
FSDP = MeshRules(strategy="fsdp")
ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
ROWS, PROMPT, MAX_SEQ, STEPS = 8, 12, 24, 4
LOGITS_REL = 1e-5
CACHE_REL = 1e-5
STEP_GRAD_FLOOR = 1e-3  # of a leaf's largest |grad|: Adam's first step is ±lr there, whatever rounding
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _flat(tree):
    return {k: _flat(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree)


def _configs(arch: str, cf: float = 4.0):
    """The JAX smoke config and the port's with EP under "fsdp", and its
    impl="local" twin, at capacity factor `cf`, in float32."""
    jcfg = jax_get_arch(arch).smoke_config()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf), dtype=jnp.float32)
    cfg = get_arch(arch).smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf, impl="ep_shardmap"),
                              dtype=torch.float32, rules=FSDP)
    return jcfg, cfg, dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="local"))


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    jcfg, cfg, _ = _configs(arch)
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    return jp, interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


# ------------------------------ (a) the layout --------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_sharded_specs_equal_the_reference_and_the_layout_inverts(arch, shape):
    jcfg = dataclasses.replace(jax_get_arch(arch).smoke_config(), rules=jsh.MeshRules(strategy="fsdp"))
    _, cfg, _ = _configs(arch)
    stand_in = types.SimpleNamespace(shape=dict(zip(AXES, shape)))
    want = _flat(jtfm.param_specs(jcfg, stand_in))
    assert _flat(tfm.param_specs(cfg, stand_in)) == want
    mesh = make_mesh(shape, AXES, device="cpu")
    specs = tfm.sharded_specs(cfg, mesh)
    assert {path: tuple(s) for path, s in specs.items()} == {
        (k,): v for k, v in want.items() if k != "layers"} | {("layers", k): v for k, v in want["layers"].items()}
    assert tuple(specs[("layers", "we_gate")]) == (None, None, AXES, None)  # ZeRO-3: the experts whole
    assert tuple(specs[("layers", "we_down")]) == (None, None, None, AXES)
    _, p = _jax_params(arch)
    laid = tfm.shard_params(p, cfg, mesh)
    m = cfg.moe
    d_l = cfg.d_model // (shape[0] * shape[1])
    assert laid["layers"]["we_gate"].shape == (*shape, cfg.n_layers, m.num_experts, d_l, m.d_ff_expert)
    assert laid["layers"]["we_gate"].movedim(2, 0).is_contiguous()  # layer-major
    back = tfm.unshard_params(laid, cfg, mesh)
    assert back["layers"]["we_up"].shape[1] == m.num_experts
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(p)))


# ------------------------------ (b) the composed FFN --------------------------------


def _ffn_config(m):
    """A one-layer transformer of width D around the MoE config `m` under
    "fsdp" (its attention and vocab unused here)."""
    return tfm.TransformerConfig("moe-ffn", n_layers=1, d_model=D, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                                 moe=m, dtype=torch.float32, rules=FSDP)


def _laid_layer(m, lp: dict, norm: np.ndarray, mesh) -> tuple:
    """The config and one layer's weights (`lp`'s MoE leaves, `norm` as
    mlp_norm) laid out on `mesh` by `shard_params`."""
    cfg = _ffn_config(m)
    params = tfm.init_params(cfg, 0, device="cpu")
    params["layers"].update({k: torch.from_numpy(v)[None] for k, v in lp.items()})
    params["layers"]["mlp_norm"] = torch.from_numpy(norm)[None]
    return cfg, tfm._layers(tfm.shard_params(params, cfg, mesh), 1)[0]


# (mesh, capacity factor, shared expert, tokens (B, S)): rows split over both axes, one row held whole, a decode
# batch of one row an engine, and a longer batch whose slots drop at 1.25
FFN_CASES = [(shape, cf, shared, (shape[0] * shape[1], 6)) for shape in ((2, 2), (2, 4)) for cf in (1.25, 4.0)
             for shared in (False, True)]
FFN_CASES += [((2, 4), cf, True, (1, 16)) for cf in (1.25, 4.0)]
FFN_CASES += [((2, 4), cf, shared, (8, 1)) for cf, shared in ((1.25, True), (4.0, False))]
FFN_CASES += [((2, 4), 1.25, shared, (8, 50)) for shared in (False, True)]
FFN_CASES += [((3, 2), 4.0, True, (6, 6))]  # d_model 32 does not divide over 6 engines: the stacks whole


@pytest.mark.parametrize("shape,cf,shared,tokens", FFN_CASES)
def test_the_composed_moe_ffn_matches_the_reference_per_device_body(shape, cf, shared, tokens, monkeypatch):
    jm, m, lp, x = _case(shared=shared, cf=cf, tokens=tokens, seed=shape[0] * 10 + shape[1] + tokens[1])
    norm = (1.0 + 0.3 * np.random.default_rng(9).standard_normal(D)).astype(np.float32)
    h = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(norm)))
    want = _reference_ep(jm, lp, h, shape, monkeypatch)

    mesh = make_mesh(shape, AXES, device="cpu")
    cfg, layer = _laid_layer(m, lp, norm, mesh)
    G, ep = shape
    split = D % (G * ep) == 0  # ZeRO-3 over both axes where d_model divides, else whole; the experts unpadded
    want_shape = (G, ep, m.num_experts, D // (G * ep), m.d_ff_expert) if split else (1, 1, m.num_experts, D,
                                                                                      m.d_ff_expert)
    assert layer["we_gate"].shape == want_shape
    plan = dense_mesh._plan(cfg, mesh, tfm._layout_specs(cfg, mesh), tokens[0])
    assert plan.batch == (AXES if tokens[0] % (G * ep) == 0 else ()) and plan.tp is None
    spec = P(plan.batch or None, None, None)
    xl = shard_tensor(torch.from_numpy(x), spec, mesh)
    moe.moe_block.ep_log = log = []
    try:
        out = dense_mesh._moe_ffn(m, plan, xl, frozenset(plan.batch), layer)
    finally:
        moe.moe_block.ep_log = None
    assert out.shape == xl.shape
    got = unshard_tensor(out, spec, mesh).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= EP_TOL

    (route,) = log
    hn = rms_norm(torch.from_numpy(x), torch.from_numpy(norm))
    plain, stage1, stage2 = moe.moe_ep_loop_ref(m, {k: torch.from_numpy(v) for k, v in lp.items()}, hn, mesh)
    assert torch.equal(route.stage1, stage1) and torch.equal(route.stage2, stage2)
    assert float(np.abs(got - plain.numpy()).max()) <= EP_TOL
    e_l = m.padded_experts(ep) // ep
    n_l = -(-tokens[0] * tokens[1] // (G * ep))  # the padded flat batch over every engine
    assert (route.Cs, route.Ce) == moe.ep_capacities(m, n_l, ep, e_l)
    padded = route.stage2.view(G, ep, e_l + 1)[:, :, :e_l].reshape(G, ep * e_l)[:, m.num_experts:]
    assert int(padded.sum()) == 0  # the zero experts get no slot
    if tokens == (8, 50):
        assert int((stage1 - route.Cs).clamp_min(0).sum()) + int((stage2[:, :-1] - route.Ce).clamp_min(0).sum()) > 0


def test_each_layout_takes_its_branch_of_moe_ep_rows():
    """Rows split over both axes, and a decode batch of one row an engine,
    are routed in place: nothing gathered, nothing cut out; one row held
    whole goes through the reference's flat layout."""
    _, m, lp, _ = _case(shared=False, cf=4.0)
    mesh = make_mesh((2, 4), AXES, device="cpu")
    norm = np.ones(D, np.float32)
    cfg, layer = _laid_layer(m, lp, norm, mesh)
    specs = tfm._layout_specs(cfg, mesh)["layers"]
    slabs = dict(layer, **moe.zero3_expert_slabs(m, layer, {k: specs[k][1:] for k in moe.EXPERT_KEYS}, mesh))
    assert slabs["we_gate"].shape == (1, 4, 2, D, m.d_ff_expert)  # EP's slab: 8 experts (6 padded) over 4
    router = torch.from_numpy(lp["router"]).view(1, 1, D, m.num_experts)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_ep_flat", "gather_dim", "own_block", "_ep_engines"):
            fn = getattr(moe, name)
            mp.setattr(moe, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
        for tokens, branch in (((8, 6), ["_ep_engines"]), ((8, 1), ["_ep_engines"]),
                               ((1, 16), ["_ep_flat", "own_block", "own_block", "_ep_engines", "gather_dim"])):
            plan = dense_mesh._plan(cfg, mesh, tfm._layout_specs(cfg, mesh), tokens[0])
            x = shard_tensor(torch.randn(*tokens, D), P(plan.batch or None, None, None), mesh)
            calls.clear()
            with torch.no_grad():
                out = moe.moe_ep_rows(m, slabs, x, router, plan.batch, mesh)
            assert out.shape == x.shape and calls == branch, (tokens, calls)


# ------------------------------ (c) the served model --------------------------------


def _inputs(vocab: int) -> dict:
    rng = np.random.default_rng(vocab + 11)
    offs = rng.integers(0, 4, ROWS)
    return {"prompt": rng.integers(0, vocab, (ROWS, PROMPT)), "decode": rng.integers(0, vocab, (ROWS, 1)),
            "steps": [(rng.integers(0, vocab, (ROWS, 1)), PROMPT + 1 + offs + i) for i in range(STEPS)]}


def _serve(prefill, decode_step, batched, cache, x: dict) -> dict:
    out = {"prefill": np.asarray(prefill(x["prompt"], cache))}
    out["decode"] = np.asarray(decode_step(x["decode"], cache))
    for i, (toks, pos) in enumerate(x["steps"]):
        out[f"batched{i}"] = np.asarray(batched(toks, pos, cache))
    return out


@functools.lru_cache(maxsize=None)
def _reference_serving(arch: str) -> dict:
    jcfg, _, _ = _configs(arch)
    jp, _ = _jax_params(arch)
    state = {"cache": jtfm.init_kv_cache(jcfg, ROWS, MAX_SEQ, dtype=jnp.float32)}

    def prefill(t, _):
        logits, state["cache"] = jtfm.prefill(jp, jnp.asarray(t), state["cache"], jcfg)
        return logits

    def decode_step(t, _):
        logits, state["cache"] = jtfm.decode_step(jp, state["cache"], PROMPT, jnp.asarray(t), jcfg)
        return logits

    def batched(t, pos, _):
        logits, state["cache"] = jtfm.decode_step_batched_pos(jp, state["cache"], jnp.asarray(pos, jnp.int32),
                                                               jnp.asarray(t), jcfg)
        return logits

    return _serve(prefill, decode_step, batched, None, _inputs(jcfg.vocab))


@functools.lru_cache(maxsize=None)
def _one_device_serving(arch: str) -> tuple[dict, dict]:
    _, _, local = _configs(arch)
    _, p = _jax_params(arch)
    cache = tfm.init_kv_cache(local, ROWS, MAX_SEQ, torch.float32, device="cpu")
    with torch.no_grad():
        out = _serve(lambda t, c: tfm.prefill(p, t, c, local)[0],
                     lambda t, c: tfm.decode_step(p, c, PROMPT, t, local)[0],
                     lambda t, pos, c: tfm.decode_step_batched_pos(p, c, torch.from_numpy(pos), t, local)[0],
                     cache, _inputs(local.vocab))
    return out, {k: v.numpy() for k, v in cache.items()}


def _close(got, want: np.ndarray, rel: float, what: str) -> None:
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_the_reference_and_one_device(arch, shape):
    _, cfg, _ = _configs(arch)
    _, p = _jax_params(arch)
    mesh = make_mesh(shape, AXES, device="cpu")
    params = tfm.shard_params(p, cfg, mesh)
    cache = tfm.init_kv_cache(cfg, ROWS, MAX_SEQ, torch.float32, device="cpu", mesh=mesh)
    assert tuple(cache["k"].shape) == (*shape, cfg.n_layers, ROWS // (shape[0] * shape[1]), MAX_SEQ,
                                       cfg.n_kv_heads, cfg.head_dim)
    moe.moe_block.ep_log = log = []
    try:
        with torch.no_grad():
            got = _serve(lambda t, c: tfm.prefill(params, t, c, cfg, mesh=mesh)[0],
                         lambda t, c: tfm.decode_step(params, c, PROMPT, t, cfg, mesh=mesh)[0],
                         lambda t, pos, c: tfm.decode_step_batched_pos(params, c, torch.from_numpy(pos), t, cfg,
                                                                       mesh=mesh)[0],
                         cache, _inputs(cfg.vocab))
    finally:
        moe.moe_block.ep_log = None
    # every call's engines route their own rows: a prefill's ROWS · PROMPT / engines tokens, a step's 8 / engines
    engines = shape[0] * shape[1]
    tokens = [ROWS * PROMPT // engines] + [ROWS // engines] * (1 + STEPS)
    assert [int(r.stage1[0].sum()) // cfg.moe.top_k for r in log] == [n for n in tokens for _ in range(cfg.n_layers)]
    want, (one, one_cache) = _reference_serving(arch), _one_device_serving(arch)
    assert set(got) == set(want) == set(one)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], **MODEL_TOL, err_msg=k)
        _close(v, one[k], LOGITS_REL, f"{k} vs one device")
    for k, v in tfm.unshard_kv_cache(cache, cfg, mesh).items():
        _close(v.numpy(), one_cache[k], CACHE_REL, f"cache {k}")


# ------------------------------ (d) training --------------------------------


def _batch(vocab: int, rows: int) -> dict:
    toks = np.random.default_rng(rows).integers(0, vocab, (rows, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _assert_rel(got: np.ndarray, want: np.ndarray, rel: float, what):
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max()), what


@functools.lru_cache(maxsize=None)
def _reference_grads(arch: str, rows: int) -> tuple[float, list]:
    """jax.value_and_grad of the reference's loss on `_batch(vocab, rows)`:
    (loss, the gradients' leaves)."""
    jcfg, _, _ = _configs(arch)
    jp, _ = _jax_params(arch)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab, rows).items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jtfm.loss_fn(q, jbatch, jcfg)))(jp)
    return float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)]


@pytest.mark.parametrize("rows", [4, 2])  # split over both axes of (2, 2); held whole
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_grad(arch, rows):
    _, cfg, _ = _configs(arch)
    _, p = _jax_params(arch)
    batch = _batch(cfg.vocab, rows)
    jloss, want = _reference_grads(arch, rows)
    mesh = make_mesh((2, 2), AXES, device="cpu")
    plan = dense_mesh._plan(cfg, mesh, tfm._layout_specs(cfg, mesh), rows)
    assert plan.batch == (AXES if rows == 4 else ())
    laid = tfm.shard_params(p, cfg, mesh)
    leaves = tree_leaves(laid)
    for t in leaves:
        t.requires_grad_(True)
    assert cfg.remat
    loss = tfm.loss_fn(laid, batch, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    whole = tfm.unshard_params(tree_unflatten(laid, grads), cfg, mesh)
    got = [g.numpy() for g in tree_leaves(whole)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel(g, w, TRANSFORMER_GRAD_REL, i)


def test_one_adamw_step_matches_the_reference():
    """The laid-out step (`adamw(mesh=, sharded=sharded_specs)`: the global
    norm over the ZeRO-3 blocks) against the reference's step on the whole
    params, compared where both gradients are above STEP_GRAD_FLOOR of the
    leaf's largest or both exactly 0."""
    jcfg, cfg, _ = _configs("qwen2-moe-a2.7b")
    jp, p = _jax_params("qwen2-moe-a2.7b")
    batch = _batch(cfg.vocab, 4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jinit, jstep = jloop.make_train_step(lambda q, b: jtfm.loss_fn(q, b, jcfg), jopt.adamw(TRAIN_LR), donate=False)
    _, jg = _reference_grads("qwen2-moe-a2.7b", 4)
    jstate, jm = jstep(jinit(jp), jbatch)

    mesh = make_mesh((2, 2), AXES, device="cpu")
    laid = tfm.shard_params(p, cfg, mesh)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(laid)]
    grads = torch.autograd.grad(tfm.loss_fn(tree_unflatten(laid, leaves), batch, cfg, mesh=mesh), leaves)
    tg = [g.numpy() for g in tree_leaves(tfm.unshard_params(tree_unflatten(laid, grads), cfg, mesh))]
    init, step = make_train_step(lambda q, b: tfm.loss_fn(q, b, cfg, mesh=mesh),
                                 optim.adamw(TRAIN_LR, mesh=mesh, sharded=tfm.sharded_specs(cfg, mesh)))
    state, metrics = step(init(laid), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=LOSS_RTOL, atol=0)
    got = tree_leaves(tfm.unshard_params(tree_map(lambda t: t.detach(), state.params), cfg, mesh))
    compared = 0
    for t, j, a, b in zip(got, jax.tree.leaves(jstate.params), jg, tg):
        floor = STEP_GRAD_FLOOR * float(np.abs(a).max())
        keep = ((np.abs(a) > floor) & (np.abs(b) > floor)) | ((a == 0) & (b == 0))
        np.testing.assert_allclose(t.numpy()[keep], np.asarray(j)[keep], **STEP_TOL)
        compared += int(keep.sum())
    assert compared > 0.9 * sum(t.numel() for t in got)


# ------------------------------ (e) the serving engine --------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_build_engine_on_the_mesh_serves_the_tokens_served_without_it(arch):
    _, cfg, local = _configs(arch)
    params = tfm.init_params(cfg, 4, device="cpu")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    rng = np.random.default_rng(31)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in rng.integers(3, 11, 6)]
    served = {}
    for name, c, m in (("whole", local, None), ("mesh", cfg, mesh)):
        engine = build_engine(c, params, slots=4, max_seq=32, device="cpu", mesh=m)
        assert tuple(engine.cache["k"].shape) == tfm.kv_cache_shape(c, 4, 32, m)
        for i, pr in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=pr.astype(np.int32), max_new_tokens=6))
        with torch.no_grad():
            done = engine.run_until_drained()
        served[name] = {r.uid: r.out_tokens for r in done}
    assert len(served["mesh"]) == len(prompts)
    assert served["mesh"] == served["whole"]
    with pytest.raises(ValueError, match="does not divide"):  # the slots split over all 4 engines
        build_engine(cfg, params, slots=2, max_seq=32, device="cpu", mesh=mesh)


# ------------------------------ (f) gloo --------------------------------


def test_gloo_2x2_serving_and_training_are_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("moe_fsdp", tmp_path)
    want = JOBS["moe_fsdp"](make_job_mesh("moe_fsdp", "stacked"))
    assert {k.split("/")[0] for k in want if k != "engines"} == {*ARCHS, "ffn_whole"}
    assert want["olmoe-1b-7b/grad/layers/we_gate"].shape[:2] == (2, 2)  # the ZeRO-3 stacks' gradients
    assert want["qwen2-moe-a2.7b/cache_k"].shape[:2] == (2, 2)
    assert want["ffn_whole/grad/we_gate"].shape[:2] == (1, 1)  # d_model 30 on 4 engines: the stacks whole
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        (e,) = got["engines"].tolist()
        for k, v in want.items():
            if k == "engines":
                continue
            laid = "cache" in k or "/grad/" in k or "/param/" in k or k == "ffn_whole/out"
            w = engine_block(v, e, MESH_2D[0]) if laid else v
            assert got[k].shape == w.shape and np.array_equal(got[k], w), (r, k)
    assert sorted(int(got["engines"][0]) for got in ranks) == list(range(WORLD))
    assert not torch.distributed.is_initialized()
