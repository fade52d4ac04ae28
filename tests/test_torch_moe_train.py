"""MoE training in `repro_torch` against the JAX package: the smoke
olmoe-1b-7b (8 experts top-8, no shared expert) and qwen2-moe-a2.7b (8
experts top-4 and the sigmoid-gated shared expert) on the same weights
(`repro_torch.interop`) and batches (`TokenPipeline`'s bit-equal numpy
output).  The loss and every leaf's gradient (router, expert stacks and
shared expert included) against `jax.grad` of the reference's loss, which is
cross-entropy alone; one `make_train_step` AdamW step against the
reference's; recompute on and off; `moe_block`'s gradients against the
plain loop's on the cases that drop slots; `route_log` under recompute; and
`expert_device_permutation` bit-equal to the reference's.

Tolerances, as `tests/test_torch_lm_gnn_train.py` holds llama: each gradient
within 1e-4 (float32) or 5e-2 (bfloat16) of its leaf's largest magnitude;
`moe_block` against `moe_loop_ref` within 1e-6 of the largest magnitude
(float32, widths <= 64, sums in another order); recompute and the placement
exactly.  The smoke qwen2-moe drops slots in both layers (2 × 16 tokens,
4 of 8 experts each, capacity 20), so its gradients cover dropped slots;
the smoke olmoe has k = E and drops none.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_lm_gnn_train import JAX_DTYPE, REL, _close_rel, _grads, _one_step_matches
from test_torch_moe import D, _case, _kept_port, _torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.core.noc import Torus2D
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.train.pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
DROPPING_CASES = ("e8k2", "e8k2_unnormed", "e12k3_not_pow2", "drop")
LOOP_REL = 1e-6


def _moe_pair(arch, dtype):
    jcfg = dataclasses.replace(jax_get_arch(arch).smoke_config(), dtype=JAX_DTYPE[dtype])
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype=dtype)
    jparams = jtfm.init_params(jcfg, jax.random.key(0))
    params = interop.transformer_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    host = next(iter(TokenPipeline(cfg.vocab, 16, 2, seed=0)))
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    return jcfg, jparams, cfg, params, batch, {k: jnp.asarray(v) for k, v in host.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_gradients_match_jax_grad(arch, dtype):
    jcfg, jparams, cfg, params, batch, jbatch = _moe_pair(arch, dtype)
    jloss, jgrads = jax.value_and_grad(lambda p: jtfm.loss_fn(p, jbatch, jcfg))(jparams)
    loss, grads = _grads(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=REL[dtype] / 10, atol=REL[dtype] / 10)
    _close_rel(grads, jax.tree.leaves(jgrads), REL[dtype])
    assert {"router", "we_gate", "we_up", "we_down"} <= set(params["layers"])
    assert ("ws_sig" in params["layers"]) == bool(cfg.moe.d_ff_shared)
    assert all(np.abs(g).max() > 0 for g in grads)  # every leaf gets a gradient (the router through the gates)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_adamw_step_matches_the_reference(arch):
    jcfg, jparams, cfg, params, batch, jbatch = _moe_pair(arch, torch.float32)
    _one_step_matches(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch,
                      lambda p, b: jtfm.loss_fn(p, b, jcfg), jparams, jbatch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_recompute_leaves_the_gradients_alone(arch):
    """The recompute under `remat` routes exactly as the forward did: the
    gradients equal those without recompute, bit for bit."""
    _, _, cfg, params, batch, _ = _moe_pair(arch, torch.float32)
    _, with_remat = _grads(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    _, without = _grads(lambda p, b: tfm.loss_fn(p, b, dataclasses.replace(cfg, remat=False)), params, batch)
    for a, b in zip(with_remat, without):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_log_counts_each_layer_once_a_forward(arch, remat):
    """One entry a layer a forward: the recompute in the backward (a
    second routing of the same tokens) logs nothing."""
    _, _, cfg, params, batch, _ = _moe_pair(arch, torch.float32)
    cfg = dataclasses.replace(cfg, remat=remat)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    moe.moe_block.route_log = log = []
    try:
        loss = tfm.loss_fn(params, batch, cfg)
        assert len(log) == cfg.n_layers
        forward = [(C, counts.clone()) for C, counts in log]
        torch.autograd.grad(loss, leaves)
        assert len(log) == cfg.n_layers
        with torch.no_grad():
            tfm.loss_fn(params, batch, cfg)
        assert len(log) == 2 * cfg.n_layers
    finally:
        moe.moe_block.route_log = None
        for p in leaves:
            p.requires_grad_(False)
    n = batch["tokens"].numel()
    for (C, counts), (C2, counts2) in zip(forward, log[cfg.n_layers:]):
        assert C == C2 == moe.capacity(cfg.moe, n) and int(counts.sum()) == n * cfg.moe.top_k
        assert torch.equal(counts, counts2)
        assert bool((counts > C).any()) == bool(cfg.moe.d_ff_shared)  # qwen2-moe drops slots, olmoe none


def _loop_grads(fn, m, lp, x, dy):
    """Gradients of <fn(m, lp, x), dy> w.r.t. x and every weight, in `lp`'s order."""
    lp = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
    x = x.clone().requires_grad_(True)
    out = fn(m, lp, x)
    return torch.autograd.grad((out * dy).sum(), [x, *lp.values()])


@pytest.mark.parametrize("name", DROPPING_CASES)
def test_moe_block_and_loop_gradients_equal_where_slots_drop(name):
    _, m, lp, x = _case(name, seed=0)
    p, xt = _torch(lp), torch.from_numpy(x)
    _, ti, _ = moe._router(m, p, xt.reshape(-1, D))
    assert not _kept_port(m, ti).all(), f"{name} drops no slot"
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape).astype(np.float32))
    got = _loop_grads(moe.moe_block, m, p, xt, dy)
    want = _loop_grads(lambda *a: moe.moe_loop_ref(*a)[0], m, p, xt, dy)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0 and float((g - w).abs().max()) <= LOOP_REL * scale


# ------------------------------------------------------------------ expert placement


def _zipf_counts(n_dp, n_exp, seed, shift=4):
    """The reference example's statistics: Zipf(1.1) expert popularity, each
    data-parallel shard's rotated by `shift` experts, 100,000 tokens a shard."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, n_exp + 1) ** 1.1
    counts = np.zeros((n_dp, n_exp))
    for d in range(n_dp):
        affinity = np.roll(base, d * shift)
        counts[d] = rng.multinomial(100_000, affinity / affinity.sum())
    return counts


def _ties(n_dp, n_exp, ep):
    """Every expert equally loaded but for a few: the stable sort's order decides."""
    counts = np.full((n_dp, n_exp), 7.0)
    counts[:, ::ep + 1] += 3.0
    return counts


PLACEMENT_CASES = {
    "example_zipf_16x64_ep16": (lambda: _zipf_counts(16, 64, 0), 16, None),
    "zipf_16x64_ep4": (lambda: _zipf_counts(16, 64, 1), 4, None),
    "zipf_8x64_ep8_torus2x4": (lambda: _zipf_counts(8, 64, 2), 8, Torus2D(2, 4)),
    "zipf_12x60_ep6": (lambda: _zipf_counts(12, 60, 3, shift=5), 6, None),
    "ties_8x64_ep8": (lambda: _ties(8, 64, 8), 8, None),
    "all_equal_4x16_ep4": (lambda: np.ones((4, 16)), 4, None),
}


def _reference_topology(topology):
    from repro.core.noc import Torus2D as JaxTorus2D

    return None if topology is None else JaxTorus2D(topology.kx, topology.ky)


def _assert_placement_equal(counts, ep, topology):
    perm, stats = moe.expert_device_permutation(counts, ep, topology=topology)
    jperm, jstats = jmoe.expert_device_permutation(counts, ep, topology=_reference_topology(topology))
    np.testing.assert_array_equal(perm, jperm)
    assert perm.dtype == jperm.dtype and sorted(perm.tolist()) == sorted(set(perm.tolist()))
    assert stats == jstats  # every entry, bit for bit
    return stats


@pytest.mark.parametrize("name", list(PLACEMENT_CASES))
def test_expert_device_permutation_equals_the_reference(name):
    make, ep, topology = PLACEMENT_CASES[name]
    stats = _assert_placement_equal(make(), ep, topology)
    assert stats["hops_optimized"] <= stats["hops_identity"]
    if name == "example_zipf_16x64_ep16":
        assert stats["hop_reduction"] > 1.0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), ep=st.sampled_from([2, 4, 6, 8]), n_dp=st.integers(1, 12))
def test_expert_device_permutation_equals_the_reference_on_random_counts(seed, ep, n_dp):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, (n_dp, 4 * ep)).astype(np.float64)
    _assert_placement_equal(counts, ep, None)


def test_the_placement_example_prints_the_reference_examples_lines():
    run = lambda name: subprocess.run([sys.executable, str(ROOT / "examples" / name)], capture_output=True,  # noqa: E731
                                      text=True, cwd=ROOT, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    got, want = run("torch_moe_expert_placement.py"), run("moe_expert_placement.py")
    assert got.returncode == 0 and want.returncode == 0, got.stderr[-2000:] + want.stderr[-2000:]
    lines = got.stdout.strip().splitlines()
    assert lines == want.stdout.strip().splitlines()[:len(lines)] and len(lines) == 4
    assert "make_production_mesh" not in got.stdout
