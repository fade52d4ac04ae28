"""`repro_torch.models.moe` against `repro.models.moe` on the same seeded
numpy inputs, in float32, and the MoE archs' smoke models against the JAX
package's on the same weights.

Tolerances: top-k indices, dispatch positions and kept slots equal exactly
(the same float32 router, a stable sort); `_router`, `_moe_local`,
`moe_block` and `load_balance_loss` within 1e-5 (float32 products of width
≤ 64 in another order); the whole smoke models at `test_torch_transformer`'s
2e-3, as `tests/test_models.py` holds the transformer."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.serve import build_engine as jax_build_engine
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.sharding import MeshRules
from repro.serve.engine import Request as JaxRequest
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import build_engine
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
D, F_EXPERT, F_SHARED = 32, 24, 40

# name: (E, k, shared expert, norm_topk, tokens (B, S), capacity_factor, biased router)
CASES = {
    "e8k2": (8, 2, False, True, (2, 24), 1.25, False),
    "e8k2_shared": (8, 2, True, True, (2, 24), 1.25, False),
    "e8k2_unnormed": (8, 2, False, False, (2, 24), 1.25, False),
    "e8k2_shared_unnormed": (8, 2, True, False, (2, 24), 1.25, False),
    "k_equals_e": (8, 8, False, True, (1, 20), 1.25, False),  # olmoe's smoke shape: every token reaches every expert
    "e12k3_not_pow2": (12, 3, True, False, (3, 17), 1.25, False),
    "decode_floor": (8, 2, True, True, (4, 1), 1.25, False),  # n = 4 < 8: C = 8, nothing dropped
    "drop": (8, 2, False, True, (2, 32), 1.0, True),
}


def _case(name, seed=0):
    E, k, shared, norm, (b, s), cf, biased = CASES[name]
    m = dict(num_experts=E, top_k=k, d_ff_expert=F_EXPERT, d_ff_shared=F_SHARED if shared else 0,
             norm_topk=norm, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    shapes = jmoe.layer_shapes(jmoe.MoEConfig(**m), D)
    lp = {n: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32) for n, sh in shapes.items()}
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    if biased:  # every token's first choice is expert 0
        lp["router"][:, 0] = 0.5
        x += 1.0
    return jmoe.MoEConfig(**m), moe.MoEConfig(**m), lp, x


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _kept_jax(jm, top_i):
    """(N, k) bool: the slots the reference's dispatch keeps."""
    n, k = top_i.shape
    order, pos = jmoe._sort_dispatch(top_i.reshape(-1), jm.num_experts)
    C = max(8, int(np.ceil(n * k / jm.num_experts * jm.capacity_factor)))
    kept = np.zeros(n * k, bool)
    kept[np.asarray(order)] = np.asarray(pos) < C
    return kept.reshape(n, k)


def _kept_port(m, top_i):
    plan = moe._plan(m, top_i)
    kept = torch.zeros(plan.order.shape, dtype=torch.bool)
    kept[plan.order] = plan.keep
    return kept.view(top_i.shape).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_router_dispatch_and_loss_match_jax(name):
    jm, m, lp, x = _case(name)
    flat = x.reshape(-1, D)
    jp, ji, jprobs = jmoe._router(jm, lp, jnp.asarray(flat))
    tp, ti, tprobs = moe._router(m, _torch(lp), torch.from_numpy(flat))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(tp), _np(jp), **TOL)
    np.testing.assert_allclose(_np(tprobs), _np(jprobs), **TOL)
    order, pos, counts = moe._sort_dispatch(ti.reshape(-1), m.num_experts)
    jorder, jpos = jmoe._sort_dispatch(ji.reshape(-1), jm.num_experts)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert torch.equal(counts, torch.bincount(ti.reshape(-1), minlength=m.num_experts))
    kept = _kept_port(m, ti)
    np.testing.assert_array_equal(kept, _kept_jax(jm, np.asarray(ji)))
    np.testing.assert_allclose(
        float(moe.load_balance_loss(tprobs, ti, m.num_experts)),
        float(jmoe.load_balance_loss(jprobs, ji, jm.num_experts)), **TOL)
    dropped = int((~kept).sum())
    if name == "drop":  # expert 0 is every token's first choice and keeps the first C = 16 of 64
        assert (ti[:, 0] == 0).all() and kept[:16, 0].all() and not kept[16:, 0].any()
        assert dropped >= flat.shape[0] - 16 and not _kept_jax(jm, np.asarray(ji)).all()
    if name in ("k_equals_e", "decode_floor"):  # C >= n: an expert holds every token
        assert dropped == 0
    if name == "k_equals_e":
        assert (np.sort(ti.numpy(), 1) == np.arange(m.num_experts)).all()


@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_matches_jax(name):
    jm, m, lp, x = _case(name)
    flat = x.reshape(-1, D)
    want_local = jmoe._moe_local(jm, lp, jnp.asarray(flat), MeshRules())
    got_local = moe._moe_local(m, _torch(lp), torch.from_numpy(flat))
    np.testing.assert_allclose(_np(got_local), _np(want_local), **TOL)
    want = jmoe.moe_block(jm, lp, jnp.asarray(x))
    got = moe.moe_block(m, _torch(lp), torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_loop_version_equals_moe_block(name):
    """The plain per-expert loop (no sort) against the sort's dispatch, and
    the slots each keeps; in bf16 too (its combine adds in another order)."""
    _, m, lp, x = _case(name, seed=1)
    p, xt = _torch(lp), torch.from_numpy(x)
    got = moe.moe_block(m, p, xt)
    want, kept = moe.moe_loop_ref(m, p, xt)
    torch.testing.assert_close(got, want, **TOL)
    _, ti, _ = moe._router(m, p, xt.reshape(-1, D))
    np.testing.assert_array_equal(kept.numpy(), _kept_port(m, ti))
    xb = xt.bfloat16()
    torch.testing.assert_close(moe.moe_block(m, p, xb).float(), moe.moe_loop_ref(m, p, xb)[0].float(),
                               rtol=2e-2, atol=2e-2)


def test_capacity_and_route_log():
    for arch, n, want in (("olmoe-1b-7b", 3072, 480), ("olmoe-1b-7b", 512, 80), ("qwen2-moe-a2.7b", 3072, 256),
                          ("qwen2-moe-a2.7b", 512, 43), ("olmoe-1b-7b", 4, 8), ("qwen2-moe-a2.7b", 4, 8)):
        m = get_arch(arch).model_config().moe
        assert moe.capacity(m, n) == want == max(8, int(np.ceil(n * m.top_k / m.num_experts * m.capacity_factor)))
    _, m, lp, x = _case("drop")
    assert moe.moe_block.route_log is None
    moe.moe_block.route_log = log = []
    try:
        moe.moe_block(m, _torch(lp), torch.from_numpy(x))
    finally:
        moe.moe_block.route_log = None
    (C, counts), = log
    n = x.shape[0] * x.shape[1]
    assert C == moe.capacity(m, n) == 16 and int(counts.sum()) == n * m.top_k and int(counts[0]) == n


def test_ep_shardmap_raises():
    """EP runs over a mesh (tests/test_torch_moe_ep.py); without one it raises,
    where the reference quietly runs the local path."""
    _, m, lp, x = _case("e8k2")
    with pytest.raises(ValueError, match="needs a mesh with the 'model' axis"):
        moe.moe_block(dataclasses.replace(m, impl="ep_shardmap"), _torch(lp), torch.from_numpy(x))
    assert m.padded_experts(16) == 16 and moe.MoEConfig(60, 4, 8).padded_experts(16) == 64


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_and_its_cli_train_the_moe_archs(arch):
    """`launch.train.train` and `python -m repro_torch.launch.train` train
    both smoke MoE archs for 2 steps (cross-entropy, as the reference)."""
    from repro_torch.launch.train import train

    losses = []
    state = train(arch, smoke=True, steps=2, device="cpu", log_fn=lambda _: None,
                  on_step=lambda st, metrics, batch: losses.append(float(metrics["loss"])))
    assert state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    done = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
                           "--device", "cpu", "--steps", "2"], capture_output=True, text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert done.returncode == 0, done.stderr[-2000:]
    assert "[train] done at step 2" in done.stdout and "loss=" in done.stdout


# ------------------------------ whole smoke models ------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    arch = request.param
    jcfg = jax_get_arch(arch).smoke_config()
    cfg = get_arch(arch).smoke_config()
    jparams = jtfm.init_params(jcfg, jax.random.key(0))
    return jcfg, jparams, cfg, interop.transformer_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_smoke_configs_equal_jax(pair):
    jcfg, _, cfg, p = pair
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert cfg.num_params == jcfg.num_params and cfg.num_active_params == jcfg.num_active_params
    E, dm, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    L = cfg.n_layers
    assert p["layers"]["we_gate"].shape == (L, E, dm, f) and p["layers"]["we_down"].shape == (L, E, f, dm)
    assert p["layers"]["router"].shape == (L, dm, E) and "w_gate" not in p["layers"]
    assert ("ws_sig" in p["layers"]) == bool(cfg.moe.d_ff_shared)
    if cfg.moe.d_ff_shared:
        assert p["layers"]["ws_sig"].shape == (L, dm, 1)
    # the reference's count leaves out the shared expert's (D, 1) sigmoid gate; so does the port's
    assert sum(t.numel() for t in jax.tree.leaves(p)) == cfg.num_params + (L * dm if cfg.moe.d_ff_shared else 0)


def test_forward_matches_jax(pair):
    jcfg, jp, cfg, p = pair
    toks = _tokens(2, 16, cfg.vocab, 1)
    got = tfm.forward(p, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 16, cfg.vocab) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(jtfm.forward(jp, jnp.asarray(toks), jcfg)), **MODEL_TOL)


def test_prefill_matches_jax_logits_and_cache(pair):
    jcfg, jp, cfg, p = pair
    toks = _tokens(1, 11, cfg.vocab, 3)
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jtfm.init_kv_cache(jcfg, 1, 14, dtype=jnp.float32), jcfg)
    cache = tfm.init_kv_cache(cfg, 1, 14, dtype=torch.float32, device="cpu")
    lg, _ = tfm.prefill(p, torch.from_numpy(toks), cache, cfg)
    np.testing.assert_allclose(_np(lg), _np(jl), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jc[name]), **MODEL_TOL)


def test_decode_step_batched_pos_matches_jax(pair):
    """Slots at their own positions (row 0 prefilled with 6 tokens, row 1
    with 3); the 2 decode tokens are routed together."""
    jcfg, jp, cfg, p = pair
    toks = _tokens(2, 6, cfg.vocab, 5)
    jc = jtfm.init_kv_cache(jcfg, 2, 10, dtype=jnp.float32)
    cache = tfm.init_kv_cache(cfg, 2, 10, dtype=torch.float32, device="cpu")
    for row, n in ((0, 6), (1, 3)):
        _, sub = jtfm.prefill(jp, jnp.asarray(toks[row:row + 1, :n]),
                              {k: v[:, row:row + 1] for k, v in jc.items()}, jcfg)
        jc = {k: jc[k].at[:, row:row + 1].set(sub[k]) for k in jc}
        tfm.prefill(p, torch.from_numpy(toks[row:row + 1, :n]),
                    {k: v[:, row:row + 1] for k, v in cache.items()}, cfg)
    pos = np.array([6, 3], np.int32)
    nxt = _tokens(2, 1, cfg.vocab, 6)
    for _ in range(3):
        jl, jc = jtfm.decode_step_batched_pos(jp, jc, jnp.asarray(pos), jnp.asarray(nxt), jcfg)
        lg, cache = tfm.decode_step_batched_pos(p, cache, torch.from_numpy(pos), torch.from_numpy(nxt), cfg)
        np.testing.assert_allclose(_np(lg), _np(jl), **MODEL_TOL)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = pos + 1
    np.testing.assert_allclose(_np(cache["v"]), _np(jc["v"]), **MODEL_TOL)


def test_served_tokens_equal_jax(pair):
    """Ragged prompts over 3 slots: the same requests drain in the same order
    with the same greedy tokens."""
    jcfg, jp, cfg, p = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (5, 9, 3, 12, 7)]
    jeng = jax_build_engine(jcfg, jp, slots=3, max_seq=24)
    eng = build_engine(cfg, p, slots=3, max_seq=24, device="cpu")
    for i, prompt in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=prompt, max_new_tokens=6))
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
    want, got = jeng.run_until_drained(), eng.run_until_drained()
    assert len(got) == len(prompts)
    assert [(r.uid, r.out_tokens) for r in got] == [(r.uid, r.out_tokens) for r in want]


def test_cast_params_keeps_the_router_and_is_bit_identical(pair):
    _, _, cfg, _ = pair
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p = tfm.init_params(cfg, 3, device="cpu")
    cast = tfm.cast_params(p, cfg)
    assert cast["layers"]["we_gate"].dtype == torch.bfloat16
    assert cast["layers"]["router"].dtype == torch.float32 and cast["layers"]["router"] is p["layers"]["router"]
    toks = torch.from_numpy(_tokens(2, 6, cfg.vocab, 9))
    assert torch.equal(tfm.forward(cast, toks, cfg), tfm.forward(p, toks, cfg))


def test_interop_carries_the_expert_stacks_and_refuses_a_wrong_tree(pair):
    jcfg, jp, cfg, p = pair
    tree = jax.tree.map(np.asarray, jp)
    for name in tree["layers"]:
        np.testing.assert_array_equal(p["layers"][name].numpy(), tree["layers"][name])
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "router"})
    with pytest.raises(ValueError):
        interop.transformer_params(bad, cfg, device="cpu")
    bad = dict(tree, layers=dict(tree["layers"], we_gate=tree["layers"]["we_gate"][:, :-1]))
    with pytest.raises(ValueError, match="we_gate"):
        interop.transformer_params(bad, cfg, device="cpu")
    dense = dict(tree, layers=dict(tree["layers"], w_gate=tree["layers"]["we_gate"][:, 0]))
    with pytest.raises(ValueError):
        interop.transformer_params(dense, cfg, device="cpu")
