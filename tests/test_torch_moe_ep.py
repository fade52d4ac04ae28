"""`repro_torch.models.moe`'s expert parallelism (impl="ep_shardmap") against
the JAX package on the same seeded numpy inputs, in float32.

The reference of record is the reference's per-device body
`repro.models.moe._moe_ep_local_body` under nested `jax.vmap` (the data
axis outer, `axis_name="model"` inner, so its `lax.all_to_all` runs on one
CPU device), composed into the reference's `moe_block` for the shared
expert.  The port's EP runs on a stacked `make_mesh` of the same shape and
must be within 2e-5 (the reference's own bound for EP against local,
`tests/test_multidevice_subprocess.py`): at capacity_factor 1.25 (slots drop
in both stages: EP then differs from the local path) and 4.0 (nothing drops:
EP equals local), on meshes (1, 4), (2, 2) and (2, 4), with 6 experts padded
to 8, with and without a shared expert; a decode of 3 tokens on 8 engines;
the smoke olmoe and qwen2-moe forwards with EP at 4.0 (every leaf and the KV
cache laid out: TP attention, EP experts) against the reference's forward; a
gloo run of 4 ranks on a 2 × 2 mesh bit-equal to stacked; the refusal without
a mesh; and EP's plain version, `moe_ep_loop_ref`, against both the reference
and the port, slot counts included."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_engines_mesh, make_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

EP_TOL = 2e-5
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
D, F_EXPERT, F_SHARED = 32, 48, 40


def _case(E=6, k=2, shared=False, cf=1.25, tokens=(4, 16), norm=True, seed=0):
    kw = dict(num_experts=E, top_k=k, d_ff_expert=F_EXPERT, d_ff_shared=F_SHARED if shared else 0,
              capacity_factor=cf, norm_topk=norm)
    rng = np.random.default_rng(seed)
    jm = jmoe.MoEConfig(**kw, impl="ep_shardmap")
    lp = {n: (rng.standard_normal(s) * 0.2).astype(np.float32) for n, s in jmoe.layer_shapes(jm, D).items()}
    x = rng.standard_normal((*tokens, D)).astype(np.float32)
    return jm, moe.MoEConfig(**kw, impl="ep_shardmap"), lp, x


def _reference_ep(jm, lp, x, shape, monkeypatch):
    """The reference's `moe_block` with its routed part from the per-device
    body vmapped over a (data, model) = `shape` layout."""
    G, ep = shape
    e_pad = jm.padded_experts(ep)

    def vmapped(m, lpj, flat, r):
        n, d = flat.shape
        n_pad = -(-n // (G * ep)) * (G * ep)
        xp = jnp.pad(flat, ((0, n_pad - n), (0, 0)))
        w = [jnp.pad(lpj[k], ((0, e_pad - m.num_experts), (0, 0), (0, 0))).reshape(ep, e_pad // ep,
                                                                                   *lpj[k].shape[1:])
             for k in ("we_gate", "we_up", "we_down")]
        body = functools.partial(jmoe._moe_ep_local_body, m, ep, e_pad)
        inner = jax.vmap(body, in_axes=(0, None, 0, 0, 0), axis_name="model")
        outer = jax.vmap(inner, in_axes=(0, None, None, None, None), axis_name="data")
        return jax.jit(outer)(xp.reshape(G, ep, -1, d), lpj["router"], *w).reshape(n_pad, d)[:n]

    monkeypatch.setattr(jmoe, "_moe_ep", vmapped)
    return np.asarray(jmoe.moe_block(jm, {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x)))


def _local(jm, lp, x):
    return np.asarray(jmoe.moe_block(dataclasses.replace(jm, impl="local"), {k: jnp.asarray(v) for k, v in lp.items()},
                                     jnp.asarray(x)))


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _laid_out(m, lp, mesh):
    """The layer's weights as EP takes them: the expert stacks laid out on `mesh`."""
    return moe.shard_experts(m, _torch(lp), mesh)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("shared", [False, True])
def test_ep_matches_the_reference_per_device_body(shape, cf, shared, monkeypatch):
    jm, m, lp, x = _case(shared=shared, cf=cf, seed=shape[0] * 10 + shape[1])
    want = _reference_ep(jm, lp, x, shape, monkeypatch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    moe.moe_block.ep_log = log = []
    try:
        got = moe.moe_block(m, _laid_out(m, lp, mesh), torch.from_numpy(x), mesh=mesh).numpy()
    finally:
        moe.moe_block.ep_log = None
    assert got.shape == x.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= EP_TOL
    (route,) = log
    G, ep = shape
    e_l = m.padded_experts(ep) // ep
    n_l = x.shape[0] * x.shape[1] // (G * ep)
    assert (route.Cs, route.Ce) == moe.ep_capacities(m, n_l, ep, e_l)
    assert route.Cs == max(8, int(np.ceil(n_l * m.top_k / ep * cf)))
    assert route.stage1.shape == (G * ep, ep) and int(route.stage1.sum()) == G * ep * n_l * m.top_k
    # the padded experts (6 → 8 on 4 model engines) get no slot: the last local experts of the last engine
    padded = route.stage2.view(G, ep, e_l + 1)[:, :, :e_l].reshape(G, ep * e_l)[:, m.num_experts:]
    assert padded.shape[1] == m.padded_experts(ep) - m.num_experts == (2 if ep == 4 else 0)
    assert int(padded.sum()) == 0
    local = _local(jm, lp, x)
    if cf == 4.0:  # nothing drops: EP is the local path
        assert int((route.stage1 - route.Cs).clamp_min(0).sum()) == 0
        assert float(np.abs(got - local).max()) <= EP_TOL
    elif shape != (2, 2):  # slots drop, so EP keeps other slots than the local path
        assert int((route.stage1 - route.Cs).clamp_min(0).sum()) > 0
        assert float(np.abs(want - local).max()) > 1e-3


@pytest.mark.parametrize("shape, cf, E, shared", [((2, 4), 1.25, 6, False), ((1, 4), 1.25, 6, True),
                                                  ((2, 2), 1.0, 8, False), ((2, 4), 4.0, 6, True)])
def test_the_plain_ep_loop_matches_the_reference_and_the_port(shape, cf, E, shared, monkeypatch):
    """`moe_ep_loop_ref`, the plain version `chip_smoke.py` holds EP against
    on the card where slots drop: within 2e-5 of the reference's vmapped
    per-device body, and the same slots in both stages as the port's EP."""
    jm, m, lp, x = _case(E=E, shared=shared, cf=cf, seed=7)
    want = _reference_ep(jm, lp, x, shape, monkeypatch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    plain, stage1, stage2 = moe.moe_ep_loop_ref(m, _torch(lp), torch.from_numpy(x), mesh)
    assert float(np.abs(plain.numpy() - want).max()) <= EP_TOL
    moe.moe_block.ep_log = log = []
    try:
        got = moe.moe_block(m, _laid_out(m, lp, mesh), torch.from_numpy(x), mesh=mesh)
    finally:
        moe.moe_block.ep_log = None
    (route,) = log
    assert torch.equal(route.stage1, stage1) and torch.equal(route.stage2, stage2)
    assert float((got - plain).abs().max()) <= EP_TOL
    if cf == 1.0:  # this case drops slots in both stages
        assert int((stage1 - route.Cs).clamp_min(0).sum()) > 0 and int((stage2[:, :-1] - route.Ce).clamp_min(0).sum()) > 0


def test_a_decode_of_three_tokens_on_eight_engines(monkeypatch):
    jm, m, lp, x = _case(shared=True, tokens=(3, 1), seed=5)
    want = _reference_ep(jm, lp, x, (2, 4), monkeypatch)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    got = moe.moe_block(m, _laid_out(m, lp, mesh), torch.from_numpy(x), mesh=mesh)
    assert got.shape == (3, 1, D) and float(np.abs(got.numpy() - want).max()) <= EP_TOL
    assert float(np.abs(got.numpy() - _local(jm, lp, x)).max()) <= EP_TOL  # 3 tokens drop nothing


def test_the_model_axis_may_come_first_and_a_1d_model_mesh_serves(monkeypatch):
    jm, m, lp, x = _case(E=8, k=2, tokens=(2, 16), seed=3)
    want = _reference_ep(jm, lp, x, (2, 4), monkeypatch)
    mesh = make_mesh((4, 2), ("model", "data"), device="cpu")
    got = moe.moe_block(m, _laid_out(m, lp, mesh), torch.from_numpy(x), mesh=mesh)
    assert float(np.abs(got.numpy() - want).max()) <= EP_TOL
    want = _reference_ep(jm, lp, x, (1, 4), monkeypatch)
    mesh = make_mesh((4,), ("model",), device="cpu")
    got = moe.moe_block(m, _laid_out(m, lp, mesh), torch.from_numpy(x), mesh=mesh)
    assert float(np.abs(got.numpy() - want).max()) <= EP_TOL


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_smoke_forward_with_ep_matches_the_reference_forward(arch):
    """At capacity_factor 4.0 nothing drops, so the reference's forward
    (which, with no mesh, runs the local path) is the function EP computes."""
    jcfg = jax_get_arch(arch).smoke_config()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=4.0))
    cfg = get_arch(arch).smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0, impl="ep_shardmap"))
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    p = interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(jtfm.forward(jp, jnp.asarray(toks), jcfg))
    for shape in ((2, 4), (1, 8)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        got = tfm.forward(tfm.shard_params(p, cfg, mesh), torch.from_numpy(toks), cfg, mesh=mesh)
        np.testing.assert_allclose(got.detach().numpy(), want, **MODEL_TOL)
    with torch.no_grad():  # prefill and a decode step take the mesh too
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        sharded = tfm.shard_params(p, cfg, mesh)
        cache = tfm.init_kv_cache(cfg, 2, 20, dtype=torch.float32, device="cpu", mesh=mesh)
        lg, _ = tfm.prefill(sharded, torch.from_numpy(toks), cache, cfg, mesh=mesh)
        np.testing.assert_allclose(lg.numpy(), want[:, -1], **MODEL_TOL)
        step, _ = tfm.decode_step(sharded, cache, 16, torch.from_numpy(toks[:, :1]), cfg, mesh=mesh)
        local = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="local"))
        cache2 = tfm.init_kv_cache(cfg, 2, 20, dtype=torch.float32, device="cpu")
        tfm.prefill(p, torch.from_numpy(toks), cache2, local)
        step2, _ = tfm.decode_step(p, cache2, 16, torch.from_numpy(toks[:, :1]), local)
        np.testing.assert_allclose(step.numpy(), step2.numpy(), rtol=1e-5, atol=1e-5)


def test_gloo_2x2_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("moe_ep", tmp_path)
    want = JOBS["moe_ep"](make_job_mesh("moe_ep", "stacked"))
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and np.array_equal(got[k], v), (r, k)
    assert not torch.distributed.is_initialized()


def test_ep_needs_a_mesh_with_the_model_axis():
    _, m, lp, x = _case()
    with pytest.raises(ValueError, match="needs a mesh with the 'model' axis"):
        moe.moe_block(m, _torch(lp), torch.from_numpy(x))
    with pytest.raises(ValueError, match="needs a mesh with the 'model' axis"):
        moe.moe_block(m, _torch(lp), torch.from_numpy(x), mesh=make_engines_mesh(num_engines=4, device="cpu"))
    with pytest.raises(ValueError, match="unknown MoE impl"):
        moe.moe_block(dataclasses.replace(m, impl="ep"), _torch(lp), torch.from_numpy(x))
    # the local path ignores a mesh
    local = dataclasses.replace(m, impl="local")
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert torch.equal(moe.moe_block(local, _torch(lp), torch.from_numpy(x), mesh=mesh),
                       moe.moe_block(local, _torch(lp), torch.from_numpy(x)))
