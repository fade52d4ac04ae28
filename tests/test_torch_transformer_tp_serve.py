"""Serving the dense transformer under Megatron TP and FSDP on the port's
("data", "model") engine mesh (`models.dense_mesh.prefill` / `decode`) against
the JAX package, on the same seeded numpy inputs, in float32.

* `prefill`, `decode_step` and four `decode_step_batched_pos` steps (the rows
  at their own positions) with the params laid out by `shard_params` and the
  KV cache by `init_kv_cache(..., mesh=)` (`kv_cache_specs`' layout), against
  `repro.models.transformer`'s same functions on the whole params, with the
  weights carried across by `interop.transformer_params`: the reference's
  2 × 2 test shape (2 layers, d 64, 4 heads, 2 KV heads, d_ff 128, vocab
  128) with a batch of 8 rows, on stacked meshes (1, 4) and (2, 4) (2 KV
  heads on 4 model engines: the head-gather path, the cache whole along
  "model") and (2, 2) (the heads on their engines), under "tp_sp" and
  "fsdp", and a vocab of 130 (whole on 4 model engines).  Logits within
  1e-5 of the largest |logit|, the unsharded cache within 1e-5 of its
  largest entry;
* a one-slot prefill (the engine's admission) writes its slot's row only,
  equal to the reference's prefill of that prompt alone;
* `launch.serve.build_engine(..., mesh=)` on stacked (2, 2) serves the
  tokens that `build_engine` without a mesh serves on the same weights;
* whole params, a whole cache, a slot count or a decode batch that does not
  divide over the rules' batch axes are refused; an MoE config with EP on a
  mesh lays its cache out as a dense model's (`test_torch_moe_tp_serve.py`
  holds that path);
* one gloo run (4 spawned ranks on a 2 × 2 mesh, a permutation that is not
  the identity, `tests/_torch_mesh_runs.py`'s `dense_tp_serve` job): the
  logits and each rank's cache block bit-equal to stacked under "tp_sp", its
  head-gather path and "fsdp".
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, MESH_2D, WORLD, dense_tp_config, engine_block, make_job_mesh, run_gloo
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_mesh
from repro_torch.launch.serve import build_engine
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request

AXES = ("data", "model")
ROWS, PROMPT, MAX_SEQ, STEPS = 8, 12, 24, 4
LOGITS_REL = 1e-5
CACHE_REL = 1e-5


def _jax_pair(vocab: int):
    """The reference's 2 × 2 test shape at `vocab`: the JAX config and
    weights, and the same weights as the port's params."""
    jcfg = jtfm.TransformerConfig("t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=vocab,
                                  dtype=jnp.float32)
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    cfg = dense_tp_config("tp_sp", vocab=vocab)
    return jcfg, jp, interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _inputs(vocab: int) -> dict:
    """The prompt (ROWS, PROMPT), a decode_step's tokens at PROMPT, and STEPS
    batched steps' tokens and positions (PROMPT + 1 + a row's own offset)."""
    rng = np.random.default_rng(vocab + 1)
    offs = rng.integers(0, 4, ROWS)
    return {"prompt": rng.integers(0, vocab, (ROWS, PROMPT)), "decode": rng.integers(0, vocab, (ROWS, 1)),
            "steps": [(rng.integers(0, vocab, (ROWS, 1)), PROMPT + 1 + offs + i) for i in range(STEPS)]}


@functools.lru_cache(maxsize=None)
def _reference(vocab: int):
    """The reference's logits of the prefill, the decode_step and each batched
    step, and its cache after the prefill and after the last step."""
    jcfg, jp, _ = _jax_pair(vocab)
    x = _inputs(vocab)
    cache = jtfm.init_kv_cache(jcfg, ROWS, MAX_SEQ, dtype=jnp.float32)
    logits, cache = jax.jit(lambda p, t, c: jtfm.prefill(p, t, c, jcfg))(jp, jnp.asarray(x["prompt"]), cache)
    out = {"prefill": np.asarray(logits), "cache_prefill": {k: np.asarray(v) for k, v in cache.items()}}
    logits, cache = jtfm.decode_step(jp, cache, PROMPT, jnp.asarray(x["decode"]), jcfg)
    out["decode"] = np.asarray(logits)
    step = jax.jit(lambda p, c, pos, t: jtfm.decode_step_batched_pos(p, c, pos, t, jcfg))
    for i, (toks, pos) in enumerate(x["steps"]):
        logits, cache = step(jp, cache, jnp.asarray(pos, jnp.int32), jnp.asarray(toks))
        out[f"batched{i}"] = np.asarray(logits)
    out["cache_end"] = {k: np.asarray(v) for k, v in cache.items()}
    return out


def _close(got: torch.Tensor, want: np.ndarray, rel: float, what: str) -> None:
    got = got.numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (what, err, scale)


def _served(cfg, params, mesh):
    return tfm.shard_params(params, cfg, mesh), tfm.init_kv_cache(cfg, ROWS, MAX_SEQ, torch.float32, device="cpu",
                                                                  mesh=mesh)


# (mesh, strategy, vocab): the test shape on every mesh; 130 does not divide over 4 model engines
CASES = [(shape, strategy, 128) for shape in ((1, 4), (2, 2), (2, 4)) for strategy in ("tp_sp", "fsdp")]
CASES += [((2, 4), strategy, 130) for strategy in ("tp_sp", "fsdp")]


@pytest.mark.parametrize("shape,strategy,vocab", CASES)
def test_prefill_and_decode_steps_match_the_unsharded_reference(shape, strategy, vocab):
    _, _, p = _jax_pair(vocab)
    cfg = dense_tp_config(strategy, vocab=vocab)
    mesh = make_mesh(shape, AXES, device="cpu")
    spec = tfm.kv_cache_specs(cfg, mesh)["k"]
    assert tuple(spec)[3] == ("model" if strategy == "tp_sp" and shape[1] == 2 else None)
    want, x = _reference(vocab), _inputs(vocab)
    params, cache = _served(cfg, p, mesh)
    assert tuple(cache["k"].shape) == tfm.kv_cache_shape(cfg, ROWS, MAX_SEQ, mesh)
    with torch.no_grad():
        logits, same = tfm.prefill(params, x["prompt"], cache, cfg, mesh=mesh)
        assert same is cache
        _close(logits, want["prefill"], LOGITS_REL, "prefill")
        for k, v in tfm.unshard_kv_cache(cache, cfg, mesh).items():
            _close(v, want["cache_prefill"][k], CACHE_REL, f"cache {k} after the prefill")
        _close(tfm.decode_step(params, cache, PROMPT, x["decode"], cfg, mesh=mesh)[0], want["decode"], LOGITS_REL,
               "decode_step")
        for i, (toks, pos) in enumerate(x["steps"]):
            logits, _ = tfm.decode_step_batched_pos(params, cache, torch.from_numpy(pos), toks, cfg, mesh=mesh)
            _close(logits, want[f"batched{i}"], LOGITS_REL, f"batched step {i}")
    for k, v in tfm.unshard_kv_cache(cache, cfg, mesh).items():
        _close(v, want["cache_end"][k], CACHE_REL, f"cache {k} after the decode steps")


@pytest.mark.parametrize("shape,strategy", [((2, 2), "tp_sp"), ((2, 4), "tp_sp"), ((2, 4), "fsdp")])
def test_a_one_slot_prefill_writes_its_slots_row_only(shape, strategy):
    jcfg, jp, p = _jax_pair(128)
    cfg = dense_tp_config(strategy)
    mesh = make_mesh(shape, AXES, device="cpu")
    prompt = _inputs(128)["prompt"][5:6, :7]
    want_logits, want = jtfm.prefill(jp, jnp.asarray(prompt), jtfm.init_kv_cache(jcfg, 1, MAX_SEQ, jnp.float32), jcfg)
    params, cache = _served(cfg, p, mesh)
    with torch.no_grad():
        logits, _ = tfm.prefill(params, prompt, cache, cfg, mesh=mesh, slot=5)
    _close(logits, np.asarray(want_logits), LOGITS_REL, "one-slot prefill")
    whole = tfm.unshard_kv_cache(cache, cfg, mesh)
    for k, v in whole.items():
        _close(v[:, 5:6], np.asarray(want[k]), CACHE_REL, f"slot 5's {k}")
        assert not torch.any(v[:, :5]) and not torch.any(v[:, 6:]), k
    written = int((cache["k"].abs().sum((-3, -2, -1)) > 0).sum())  # (engine, layer, row) blocks written
    heads_split = tuple(tfm.kv_cache_specs(cfg, mesh)["k"])[3] is not None
    assert written == cfg.n_layers * (shape[1] if heads_split else 1)


@pytest.mark.parametrize("strategy", ["tp_sp", "fsdp"])
def test_build_engine_on_the_mesh_serves_the_tokens_served_without_it(strategy):
    cfg = dense_tp_config(strategy)
    params = tfm.init_params(cfg, 4, device="cpu")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in rng.integers(3, 11, 6)]
    served = {}
    for name, m in (("whole", None), ("mesh", mesh)):
        engine = build_engine(cfg, params, slots=4, max_seq=32, device="cpu", mesh=m)
        assert tuple(engine.cache["k"].shape) == tfm.kv_cache_shape(cfg, 4, 32, m)
        for i, pr in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=pr.astype(np.int32), max_new_tokens=6))
        with torch.no_grad():
            done = engine.run_until_drained()
        served[name] = {r.uid: r.out_tokens for r in done}
    assert len(served["mesh"]) == len(prompts)
    assert served["mesh"] == served["whole"]


def test_laid_out_params_are_served_as_they_are():
    cfg = dense_tp_config("tp_sp")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    laid = tfm.shard_params(tfm.init_params(cfg, 4, device="cpu"), cfg, mesh)
    engine = build_engine(cfg, laid, slots=2, max_seq=16, device="cpu", mesh=mesh)
    with torch.no_grad():
        engine.submit(Request(uid=0, prompt=np.arange(2, 9, dtype=np.int32), max_new_tokens=3))
        (done,) = engine.run_until_drained()
    assert len(done.out_tokens) == 3


def test_whole_params_and_a_whole_cache_are_refused_on_a_mesh():
    cfg = dense_tp_config("tp_sp")
    mesh = make_mesh((2, 2), AXES, device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((4, 5), dtype=torch.long)
    laid_cache = tfm.init_kv_cache(cfg, 4, 8, torch.float32, device="cpu", mesh=mesh)
    calls = {"prefill": lambda p, c: tfm.prefill(p, toks, c, cfg, mesh=mesh),
             "decode_step": lambda p, c: tfm.decode_step(p, c, 5, toks[:, :1], cfg, mesh=mesh),
             "batched": lambda p, c: tfm.decode_step_batched_pos(p, c, torch.full((4,), 5), toks[:, :1], cfg,
                                                                 mesh=mesh)}
    laid = tfm.shard_params(params, cfg, mesh)
    whole_cache = tfm.init_kv_cache(cfg, 4, 8, torch.float32, device="cpu")
    for name, call in calls.items():
        with pytest.raises(ValueError, match="params laid out on it"):
            call(params, laid_cache)
        with pytest.raises(ValueError, match="KV cache laid out on it"):
            call(laid, whole_cache)
    assert not torch.any(laid_cache["k"]) and not torch.any(whole_cache["k"])


@pytest.mark.parametrize("strategy,slots", [("tp_sp", 3), ("fsdp", 6)])
def test_a_batch_that_does_not_divide_over_the_batch_axes_is_refused(strategy, slots):
    cfg = dense_tp_config(strategy)
    mesh = make_mesh((2, 2), AXES, device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match=f"{slots} rows does not divide"):
        build_engine(cfg, params, slots=slots, max_seq=16, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match=f"{slots} rows does not divide"):
        tfm.init_kv_cache(cfg, slots, 16, device="cpu", mesh=mesh)
    laid = tfm.shard_params(params, cfg, mesh)
    cache = tfm.init_kv_cache(cfg, 4, 16, torch.float32, device="cpu", mesh=mesh)
    toks = torch.zeros((slots, 1), dtype=torch.long)
    with pytest.raises(ValueError, match=f"{slots} rows does not divide"):
        tfm.decode_step_batched_pos(laid, cache, torch.zeros(slots, dtype=torch.long), toks, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="a decode batch of 8 rows for a KV cache of 4"):
        tfm.decode_step(laid, cache, 0, torch.zeros((8, 1), dtype=torch.long), cfg, mesh=mesh)


def test_an_moe_config_on_a_mesh_keeps_its_whole_cache():
    """The name is from when an MoE config kept its whole cache on a mesh
    (EP only); under tp_sp with EP its cache is now laid out as a dense
    model's, and a one-slot prefill writes that slot's row only, equal to
    one device's prefill of the prompt alone."""
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    local = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="local"))
    mesh = make_mesh((2, 2), AXES, device="cpu")
    spec = tfm.kv_cache_specs(cfg, mesh)["k"]
    laid = (2, 2, cfg.n_layers, 2, 16, cfg.n_kv_heads // 2, cfg.head_dim)  # (data, model, L, B / 2, S, Hkv / 2, dh)
    assert tuple(spec) == (None, "data", None, "model", None) and tfm.kv_cache_shape(cfg, 4, 16, mesh) == laid
    cache = tfm.init_kv_cache(cfg, 4, 16, torch.float32, device="cpu", mesh=mesh)
    assert tuple(cache["k"].shape) == laid and tfm.unshard_kv_cache(cache, cfg, mesh)["k"].shape == (
        cfg.n_layers, 4, 16, cfg.n_kv_heads, cfg.head_dim)
    params = tfm.init_params(cfg, 0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 6)))
    with torch.no_grad():
        got, _ = tfm.prefill(tfm.shard_params(params, cfg, mesh), prompt, cache, cfg, mesh=mesh, slot=1)
        sub = tfm.init_kv_cache(local, 1, 16, torch.float32, device="cpu")
        want, _ = tfm.prefill(params, prompt, sub, local)  # one device, a one-row cache
    whole = tfm.unshard_kv_cache(cache, cfg, mesh)
    _close(got, want.numpy(), LOGITS_REL, "one-slot prefill")
    for k in ("k", "v"):
        _close(whole[k][:, 1:2], sub[k].numpy(), CACHE_REL, f"slot 1's {k}")
        assert not torch.any(whole[k][:, 0]) and not torch.any(whole[k][:, 2:]), k


def test_gloo_2x2_serving_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("dense_tp_serve", tmp_path)
    want = JOBS["dense_tp_serve"](make_job_mesh("dense_tp_serve", "stacked"))
    assert {k.split("/")[0] for k in want if k != "engines"} == {"tp_sp", "tp_sp_gather", "fsdp"}
    assert want["tp_sp_gather/cache_k"].shape[:2] == (2, 1)  # whole along "model"
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
