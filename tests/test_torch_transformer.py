"""`repro_torch.models.transformer` against `repro.models.transformer` on the
same weights and tokens: llama3.2-3b at `smoke_config()` (float32), the JAX
params carried over by `repro_torch.interop.transformer_params`.  Tolerance
rtol/atol 2e-3, as `tests/test_models.py` uses for the transformer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import PENDING, arch_ids, get_arch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer as tfm

TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "llama3.2-3b"


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jax_get_arch(ARCH).smoke_config()
    cfg = get_arch(ARCH).smoke_config()
    jparams = jtfm.init_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, interop.transformer_params(tree, cfg, device="cpu")


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def test_forward_matches_jax(pair):
    jcfg, jp, cfg, p = pair
    toks = _tokens(2, 16, cfg.vocab, 1)
    before = flash_attention.launches
    got = tfm.forward(p, torch.from_numpy(toks), cfg)
    assert flash_attention.launches == before  # CPU: the plain version
    assert got.shape == (2, 16, cfg.vocab) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(jtfm.forward(jp, jnp.asarray(toks), jcfg)), **TOL)


def test_loss_matches_jax(pair):
    jcfg, jp, cfg, p = pair
    toks = _tokens(2, 12, cfg.vocab, 2)
    labels = np.roll(toks, -1, axis=1)
    want = jtfm.loss_fn(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, jcfg)
    got = tfm.loss_fn(p, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}, cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_prefill_matches_jax_logits_and_cache(pair):
    jcfg, jp, cfg, p = pair
    toks = _tokens(2, 9, cfg.vocab, 3)
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jtfm.init_kv_cache(jcfg, 2, 12, dtype=jnp.float32), jcfg)
    cache = tfm.init_kv_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    lg, cache2 = tfm.prefill(p, torch.from_numpy(toks), cache, cfg)
    assert cache2 is cache  # written in place
    np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jc[name]), **TOL)
        assert not cache[name][:, :, 9:].any()  # only the prompt's rows are written


def test_decode_step_matches_jax(pair):
    jcfg, jp, cfg, p = pair
    toks = _tokens(2, 7, cfg.vocab, 4)
    jc = jtfm.init_kv_cache(jcfg, 2, 8, dtype=jnp.float32)
    cache = tfm.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(7):
        jl, jc = jtfm.decode_step(jp, jc, jnp.int32(i), jnp.asarray(toks[:, i:i + 1]), jcfg)
        lg, cache = tfm.decode_step(p, cache, i, torch.from_numpy(toks[:, i:i + 1]), cfg)
        np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
    np.testing.assert_allclose(_np(cache["k"]), _np(jc["k"]), **TOL)


def test_decode_step_batched_pos_matches_jax(pair):
    """Slots at their own positions: row 0 prefilled with 6 tokens, row 1 with 3."""
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
        np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = pos + 1
    np.testing.assert_allclose(_np(cache["v"]), _np(jc["v"]), **TOL)


def test_decode_matches_forward_inside_the_port(pair):
    _, _, cfg, p = pair
    toks = torch.from_numpy(_tokens(2, 8, cfg.vocab, 7))
    full = tfm.forward(p, toks, cfg)
    cache = tfm.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = tfm.decode_step(p, cache, i, toks[:, i:i + 1], cfg)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, **TOL)
    cache = tfm.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    last, _ = tfm.prefill(p, toks, cache, cfg)
    torch.testing.assert_close(last, full[:, -1], **TOL)
    # prefill of S-1 tokens then one decode step = prefill of all S
    cache = tfm.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    tfm.prefill(p, toks[:, :7], cache, cfg)
    step, _ = tfm.decode_step_batched_pos(p, cache, torch.full((2,), 7), toks[:, 7:8], cfg)
    torch.testing.assert_close(step, full[:, -1], **TOL)


def test_attention_impls_agree_inside_the_port(pair):
    _, _, cfg, p = pair
    toks = torch.from_numpy(_tokens(1, 10, cfg.vocab, 8))
    ref = tfm.forward(p, toks, cfg)
    for impl in ("ref", "naive"):
        got = tfm.forward(p, toks, dataclasses.replace(cfg, attn_impl=impl, attn_block_q=4, attn_block_k=4))
        torch.testing.assert_close(got, ref, **TOL)


def test_cast_params_is_bit_identical():
    cfg = dataclasses.replace(get_arch(ARCH).smoke_config(), dtype=torch.bfloat16)
    p = tfm.init_params(cfg, 3, device="cpu")
    cast = tfm.cast_params(p, cfg)
    assert cast["layers"]["wq"].dtype == torch.bfloat16 and p["layers"]["wq"].dtype == torch.float32
    assert tfm.cast_params(cast, cfg)["embed"] is cast["embed"]  # no second copy
    toks = torch.from_numpy(_tokens(2, 6, cfg.vocab, 9))
    assert torch.equal(tfm.forward(cast, toks, cfg), tfm.forward(p, toks, cfg))


@pytest.mark.parametrize("arch", arch_ids("lm"))
def test_configs_and_param_counts_equal_jax(arch):
    for which in ("model_config", "smoke_config"):
        jcfg, cfg = getattr(jax_get_arch(arch), which)(), getattr(get_arch(arch), which)()
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim",
                  "rope_theta", "tie_embeddings", "attn_block_q", "attn_block_k"):
            assert getattr(cfg, f) == getattr(jcfg, f), (which, f)
        assert cfg.num_params == jcfg.num_params
        assert cfg.num_active_params == jcfg.num_active_params
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert (cfg.moe is None) == (jcfg.moe is None)
        if cfg.moe is not None:  # the reference's model_config() is its dry-run's (ep_shardmap)
            assert cfg.moe.impl == "local"
            assert dataclasses.asdict(cfg.moe) == dict(dataclasses.asdict(jcfg.moe), impl="local")
    cfg, jfull = get_arch(arch).model_config(), jax_get_arch(arch).model_config(dryrun=False)
    assert (cfg.num_params, cfg.num_active_params) == (jfull.num_params, jfull.num_active_params)
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        assert get_arch(arch).model_flops(cell) == jax_get_arch(arch).model_flops(cell)


@pytest.mark.parametrize("arch,params", [("olmoe-1b-7b", 6_919_096_320), ("qwen2-moe-a2.7b", 14_315_587_584)])
def test_moe_full_width_is_the_published_one(arch, params):
    cfg = get_arch(arch).model_config()
    assert cfg.num_params == params == jax_get_arch(arch).model_config(dryrun=False).num_params
    assert cfg.num_active_params < cfg.num_params and cfg.moe.impl == "local"
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32


def test_llama_full_width_is_the_published_one():
    cfg = get_arch(ARCH).model_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab) == (
        28, 3072, 24, 8, 128, 8192, 128256)
    assert cfg.num_params == 3_606_752_256
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32


def test_init_params_has_the_jax_layout(pair):
    jcfg, jp, cfg, _ = pair
    p = tfm.init_params(cfg, 0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    assert tfm.init_params(cfg, 0, device="cpu")["embed"].equal(p["embed"])  # seeded
    assert not tfm.init_params(cfg, 1, device="cpu")["embed"].equal(p["embed"])


def test_pending_archs_raise():
    """Nothing is pending since the MoE archs came over: every arch of the JAX
    package resolves in the port, and an unknown one raises."""
    from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs.registry import ARCH_IDS

    assert not PENDING and sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    for arch in ("olmoe-1b-7b", "qwen2-moe-a2.7b"):
        assert get_arch(arch).family == "lm" and get_arch(arch).model_config().moe is not None
    with pytest.raises(ValueError):
        get_arch("no-such-arch")
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        tfm.forward(tfm.init_params(ep, device="cpu"), torch.zeros((1, 4), dtype=torch.long), ep)


def test_interop_refuses_a_wrong_tree(pair):
    jcfg, jp, cfg, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "wq"})
    with pytest.raises(ValueError):
        interop.transformer_params(bad, cfg, device="cpu")
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        interop.transformer_params(bad, cfg, device="cpu")
