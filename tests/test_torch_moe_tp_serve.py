"""Serving the MoE transformer on the port's ("data", "model") engine mesh
under tp_sp, Megatron TP attention and expert-parallel experts in one layer
(`models.dense_mesh` with `_moe_ffn`, `models.moe.moe_ep_rows`), against the
JAX package on the same seeded numpy inputs, in float32.

* (a) The composed MoE FFN (`mlp_norm`, the router laid out by
  `param_specs` and gathered, EP over "model" on each engine's own tokens,
  the shared expert under TP) on a residual laid out as `dense_mesh` holds it,
  against the reference's `moe_block` on the normed tokens with its routed
  part from the per-device body `_moe_ep_local_body` under nested `jax.vmap`
  over the tokens as `act_tokens_sp` lays the flat batch (the harness of
  `tests/test_torch_moe_ep.py`): within EP_TOL, the port's slot counts in
  both stages equal to `moe_ep_loop_ref`'s.  At capacity_factor 1.25 (slots
  drop) and 4.0 on stacked (1, 4), (2, 2), (2, 4), 6 experts padded to 8,
  with and without a shared expert, on a batch whose blocks coincide with
  the reference's (4 × 16), B = 2 × S = 13 on (2, 4) (the reference's blocks
  straddle the rows) and 2 × 50 at 1.25 (they straddle, and slots drop), one
  row held once along "data", and a decode batch of 4 slots on 8 engines.
* (b) The smoke olmoe-1b-7b and qwen2-moe-a2.7b with EP under tp_sp at
  capacity_factor 4.0 (nothing drops): `prefill`, `decode_step` and four
  `decode_step_batched_pos` steps over `shard_params` and
  `init_kv_cache(..., mesh=)` on stacked (2, 2), (2, 4) and (1, 8) (4 KV
  heads on 8 model engines: the head-gather path), against the reference's
  same functions on whole params (MODEL_TOL, the bound EP is held to), the
  port's one-device impl="local" run (logits within 1e-5 of the largest
  |logit|) and its cache (within 1e-5 of its largest entry).
* (c) A one-slot prefill writes its slot's row only.
* (d) `launch.serve.build_engine(..., mesh=)` on stacked (2, 2) serves the
  tokens that it serves without a mesh (impl="local").
* (e) An EP MoE config under "fsdp" on a mesh is laid out (the expert
  stacks ZeRO-3, by `param_specs`) and served, its forward that of one
  device (`tests/test_torch_moe_fsdp.py` holds it against the reference);
  refused: impl="local" given laid-out params, whole params given to the
  mesh; impl="local" on a mesh runs whole under either strategy.
* (f) One gloo run (4 spawned ranks on a 2 × 2 mesh, a permutation that is
  not the identity, `tests/_torch_mesh_runs.py`'s `moe_tp_serve` job): the
  logits and each rank's cache block bit-equal to stacked.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, MESH_2D, WORLD, engine_block, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_mesh
from repro_torch.launch.serve import build_engine
from repro_torch.models import dense_mesh, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm
from repro_torch.models.sharding import P, MeshRules, shard_tensor, unshard_tensor
from repro_torch.serve.engine import Request
from test_torch_moe_ep import D, EP_TOL, MODEL_TOL, _case, _reference_ep

AXES = ("data", "model")
ROWS, PROMPT, MAX_SEQ, STEPS = 4, 12, 24, 4
LOGITS_REL = 1e-5
CACHE_REL = 1e-5


# ------------------------------ (a) the composed FFN --------------------------------


def _ffn_config(m):
    """A one-layer transformer of width D around the MoE config `m` (its
    attention and vocab unused here)."""
    return tfm.TransformerConfig("moe-ffn", n_layers=1, d_model=D, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                                 moe=m, dtype=torch.float32, rules=MeshRules(strategy="tp_sp"))


# (mesh, capacity factor, shared expert, tokens (B, S)): blocks that coincide with the reference's, the
# straddling batch, one row held once along "data", a decode batch of 4 slots
FFN_CASES = [(shape, cf, shared, (4, 16)) for shape in ((1, 4), (2, 2), (2, 4)) for cf in (1.25, 4.0)
             for shared in (False, True)]
FFN_CASES += [((2, 4), cf, shared, (2, 13)) for cf in (1.25, 4.0) for shared in (False, True)]
FFN_CASES += [(shape, cf, True, (1, 16)) for shape in ((2, 2), (2, 4)) for cf in (1.25, 4.0)]
FFN_CASES += [((2, 4), cf, True, (4, 1)) for cf in (1.25, 4.0)]
FFN_CASES += [((2, 4), 1.25, shared, (2, 50)) for shared in (False, True)]  # straddling, and slots drop


@pytest.mark.parametrize("shape,cf,shared,tokens", FFN_CASES)
def test_the_composed_moe_ffn_matches_the_reference_per_device_body(shape, cf, shared, tokens, monkeypatch):
    jm, m, lp, x = _case(shared=shared, cf=cf, tokens=tokens, seed=shape[0] * 10 + shape[1] + tokens[1])
    norm = (1.0 + 0.3 * np.random.default_rng(9).standard_normal(D)).astype(np.float32)
    h = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(norm)))
    want = _reference_ep(jm, lp, h, shape, monkeypatch)  # the tokens laid out as act_tokens_sp lays them

    cfg = _ffn_config(m)
    mesh = make_mesh(shape, AXES, device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    params["layers"].update({k: torch.from_numpy(v)[None] for k, v in lp.items()})
    params["layers"]["mlp_norm"] = torch.from_numpy(norm)[None]
    laid = tfm.shard_params(params, cfg, mesh)
    assert laid["layers"]["router"].shape[:2] == (shape[0], 1)  # FSDP over "data", as param_specs lays it
    plan = dense_mesh._plan(cfg, mesh, tfm._layout_specs(cfg, mesh), tokens[0])
    assert plan.batch == (("data",) if tokens[0] % shape[0] == 0 else ())
    spec = P(plan.batch or None, None, None)
    xl = shard_tensor(torch.from_numpy(x), spec, mesh)
    moe.moe_block.ep_log = log = []
    try:
        out = dense_mesh._moe_ffn(m, plan, xl, frozenset(plan.batch), tfm._layers(laid, 1)[0])
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
    G, ep = shape
    n_l = -(-tokens[0] * tokens[1] // (G * ep))  # the padded flat batch over every engine
    assert (route.Cs, route.Ce) == moe.ep_capacities(m, n_l, ep, m.padded_experts(ep) // ep)
    if tokens == (2, 50):  # slots drop where the blocks straddle the rows: another layout would drop others
        assert int((stage1 - route.Cs).clamp_min(0).sum()) + int((stage2[:, :-1] - route.Ce).clamp_min(0).sum()) > 0


def test_each_layout_takes_its_path():
    """Blocks that coincide are taken from the rows an engine holds (no
    gather over "data"); a straddling batch, one row and a decode batch go
    through the reference's flat layout."""
    calls = []
    flat = moe._ep_flat

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return flat(*args, **kw)

    _, m, lp, _ = _case(shared=False, cf=4.0)
    cfg = _ffn_config(m)
    mesh = make_mesh((2, 4), AXES, device="cpu")
    laid = tfm._layers(tfm.shard_params(tfm.init_params(cfg, 0, device="cpu"), cfg, mesh), 1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "_ep_flat", spy)
        for tokens, gathered in (((4, 16), False), ((2, 13), True), ((1, 16), True), ((4, 1), True)):
            plan = dense_mesh._plan(cfg, mesh, tfm._layout_specs(cfg, mesh), tokens[0])
            x = shard_tensor(torch.randn(*tokens, D), P(plan.batch or None, None, None), mesh)
            calls.clear()
            with torch.no_grad():
                dense_mesh._moe_ffn(m, plan, x, frozenset(plan.batch), laid)
            assert calls == ([(1, 1, tokens[0] * tokens[1], D)] if gathered else []), tokens


# ------------------------------ (b)–(f) the served model --------------------------------


def _configs(arch: str, cf: float = 4.0):
    """The JAX smoke config and the port's, with EP under tp_sp, and its
    impl="local" twin, at capacity factor `cf`."""
    jcfg = jax_get_arch(arch).smoke_config()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    cfg = get_arch(arch).smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf, impl="ep_shardmap"))
    return jcfg, cfg, dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="local"))


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    jcfg, cfg, _ = _configs(arch)
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    return jp, interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _inputs(vocab: int) -> dict:
    rng = np.random.default_rng(vocab + 7)
    offs = rng.integers(0, 4, ROWS)
    return {"prompt": rng.integers(0, vocab, (ROWS, PROMPT)), "decode": rng.integers(0, vocab, (ROWS, 1)),
            "steps": [(rng.integers(0, vocab, (ROWS, 1)), PROMPT + 1 + offs + i) for i in range(STEPS)]}


def _serve(prefill, decode_step, batched, cache, x: dict) -> dict:
    """The logits of a prefill, a decode_step and each batched step."""
    out = {"prefill": np.asarray(prefill(x["prompt"], cache))}
    out["decode"] = np.asarray(decode_step(x["decode"], cache))
    for i, (toks, pos) in enumerate(x["steps"]):
        out[f"batched{i}"] = np.asarray(batched(toks, pos, cache))
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> dict:
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
def _one_device(arch: str) -> tuple[dict, dict]:
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


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_prefill_and_decode_steps_match_the_reference_and_one_device(arch, shape):
    _, cfg, _ = _configs(arch)
    _, p = _jax_params(arch)
    mesh = make_mesh(shape, AXES, device="cpu")
    heads_split = shape[1] <= cfg.n_kv_heads
    assert tuple(tfm.kv_cache_specs(cfg, mesh)["k"])[3] == ("model" if heads_split else None)
    params = tfm.shard_params(p, cfg, mesh)
    cache = tfm.init_kv_cache(cfg, ROWS, MAX_SEQ, torch.float32, device="cpu", mesh=mesh)
    assert tuple(cache["k"].shape) == tfm.kv_cache_shape(cfg, ROWS, MAX_SEQ, mesh)
    assert cache["k"].shape[:2] == (shape[0], shape[1] if heads_split else 1)
    with torch.no_grad():
        got = _serve(lambda t, c: tfm.prefill(params, t, c, cfg, mesh=mesh)[0],
                     lambda t, c: tfm.decode_step(params, c, PROMPT, t, cfg, mesh=mesh)[0],
                     lambda t, pos, c: tfm.decode_step_batched_pos(params, c, torch.from_numpy(pos), t, cfg,
                                                                   mesh=mesh)[0],
                     cache, _inputs(cfg.vocab))
    want, (one, one_cache) = _reference(arch), _one_device(arch)
    assert set(got) == set(want) == set(one)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], **MODEL_TOL, err_msg=k)
        _close(v, one[k], LOGITS_REL, f"{k} vs one device")
    for k, v in tfm.unshard_kv_cache(cache, cfg, mesh).items():
        _close(v.numpy(), one_cache[k], CACHE_REL, f"cache {k}")


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_a_one_slot_prefill_writes_its_slots_row_only(arch, shape):
    _, cfg, local = _configs(arch)
    _, p = _jax_params(arch)
    mesh = make_mesh(shape, AXES, device="cpu")
    prompt = _inputs(cfg.vocab)["prompt"][3:4, :7]
    cache = tfm.init_kv_cache(cfg, ROWS, MAX_SEQ, torch.float32, device="cpu", mesh=mesh)
    sub = tfm.init_kv_cache(local, 1, MAX_SEQ, torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = tfm.prefill(tfm.shard_params(p, cfg, mesh), prompt, cache, cfg, mesh=mesh, slot=3)
        want, _ = tfm.prefill(p, prompt, sub, local)
    _close(logits.numpy(), want.numpy(), LOGITS_REL, "one-slot prefill")
    for k, v in tfm.unshard_kv_cache(cache, cfg, mesh).items():
        _close(v[:, 3:4].numpy(), sub[k].numpy(), CACHE_REL, f"slot 3's {k}")
        assert not torch.any(v[:, :3]), k
    written = int((cache["k"].abs().sum((-3, -2, -1)) > 0).sum())  # (engine, layer, row) blocks written
    assert written == cfg.n_layers * shape[1]  # one data engine's block holds slot 3, on every model engine


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_build_engine_on_the_mesh_serves_the_tokens_served_without_it(arch):
    _, cfg, local = _configs(arch)
    params = tfm.init_params(cfg, 4, device="cpu")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    rng = np.random.default_rng(29)
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


def test_other_layouts_are_refused():
    _, cfg, local = _configs("qwen2-moe-a2.7b")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((4, 5), dtype=torch.long)
    fsdp = dataclasses.replace(cfg, rules=MeshRules(strategy="fsdp"))
    laid_fsdp = tfm.shard_params(params, fsdp, mesh)  # ZeRO-3 stacks: (data, model, L, E, D / 4, F), the real E
    assert laid_fsdp["layers"]["we_gate"].shape == (2, 2, cfg.n_layers, cfg.moe.num_experts, cfg.d_model // 4,
                                                    cfg.moe.d_ff_expert)
    with torch.no_grad():
        got = tfm.forward(laid_fsdp, toks, fsdp, mesh=mesh)
        assert float((got - tfm.forward(params, toks, local)).abs().max()) <= 1e-5 * float(got.abs().max())
    assert tuple(tfm.init_kv_cache(fsdp, 4, 8, device="cpu", mesh=mesh)["k"].shape[:2]) == (2, 2)
    assert build_engine(fsdp, params, slots=4, max_seq=8, device="cpu", mesh=mesh).cache["k"].shape[:2] == (2, 2)
    laid = tfm.shard_params(params, cfg, mesh)
    cache = tfm.init_kv_cache(local, 4, 8, torch.float32, device="cpu")
    for call in (lambda: tfm.forward(laid, toks, local, mesh=mesh), lambda: tfm.prefill(laid, toks, cache, local,
                                                                                         mesh=mesh),
                 lambda: tfm.decode_step(laid, cache, 5, toks[:, :1], local, mesh=mesh)):
        with pytest.raises(NotImplementedError, match="takes whole params"):
            call()
    laid_cache = tfm.init_kv_cache(cfg, 4, 8, torch.float32, device="cpu", mesh=mesh)
    for call in (lambda: tfm.forward(params, toks, cfg, mesh=mesh),
                 lambda: tfm.prefill(params, toks, laid_cache, cfg, mesh=mesh),
                 lambda: tfm.decode_step_batched_pos(params, laid_cache, torch.full((4,), 5), toks[:, :1], cfg,
                                                     mesh=mesh)):
        with pytest.raises(ValueError, match="params laid out on it"):
            call()
    with pytest.raises(ValueError, match="we_gate"):  # whole expert stacks beside laid-out leaves
        tfm.forward(dict(laid, layers=dict(laid["layers"], **{k: params["layers"][k] for k in moe.EXPERT_KEYS})),
                    toks, cfg, mesh=mesh)
    # the local path on a mesh with whole params ignores the mesh, under either strategy
    with torch.no_grad():
        assert torch.equal(tfm.forward(params, toks, local, mesh=mesh), tfm.forward(params, toks, local))
    local_fsdp = dataclasses.replace(local, rules=MeshRules(strategy="fsdp"))
    assert tfm.shard_params(params, local_fsdp, mesh) is params
    assert tfm.kv_cache_shape(local_fsdp, 4, 8, mesh=mesh) == tfm.kv_cache_shape(local, 4, 8)
    with torch.no_grad():
        assert torch.equal(tfm.forward(params, toks, local_fsdp, mesh=mesh), tfm.forward(params, toks, local))
        got_cache = tfm.init_kv_cache(local_fsdp, 4, 8, torch.float32, device="cpu", mesh=mesh)
        want_cache = tfm.init_kv_cache(local, 4, 8, torch.float32, device="cpu")
        got = tfm.prefill(params, toks, got_cache, local_fsdp, mesh=mesh)[0]
        assert torch.equal(got, tfm.prefill(params, toks, want_cache, local)[0])
        assert all(torch.equal(got_cache[k], want_cache[k]) for k in ("k", "v"))
        got = tfm.decode_step(params, got_cache, 5, toks[:, :1], local_fsdp, mesh=mesh)[0]
        assert torch.equal(got, tfm.decode_step(params, want_cache, 5, toks[:, :1], local)[0])
    engine = build_engine(local_fsdp, params, slots=4, max_seq=8, device="cpu", mesh=mesh)
    assert engine.cache["k"].shape == want_cache["k"].shape


def test_gloo_2x2_serving_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("moe_tp_serve", tmp_path)
    want = JOBS["moe_tp_serve"](make_job_mesh("moe_tp_serve", "stacked"))
    assert {k.split("/")[0] for k in want if k != "engines"} == {"olmoe-1b-7b", "qwen2-moe-a2.7b"}
    assert want["olmoe-1b-7b/cache_k"].shape[:2] == (2, 2)
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        (e,) = got["engines"].tolist()
        for k, v in want.items():
            if k == "engines":
                continue
            w = engine_block(v, e, MESH_2D[0]) if "cache" in k else v
            assert got[k].shape == w.shape and np.array_equal(got[k], w), (r, k)
    assert sorted(int(got["engines"][0]) for got in ranks) == list(range(WORLD))
    assert not torch.distributed.is_initialized()
