"""LM and GNN training in `repro_torch` against the JAX package on the same
weights (`repro_torch.interop`) and batches (the pipelines' bit-equal numpy
output): the loss and every leaf's gradient against `jax.grad` of the
reference's loss, then one `make_train_step` AdamW step against the
reference's step; the training CLI on the host.

Configurations: the smoke llama3.2-3b in float32 (`dtype` replaced in both
configs) and in bfloat16; gin-tu (through the ELL reduce with its transposed
ELL, and through the scatter route), gat-cora and pna at smoke width on the
reference launcher's graph (R-MAT, 512 nodes, 4,096 edges, multi-edges
included), and gin-tu at `full_graph_sm`'s width (d_in 1,433).

Tolerances, each gradient against its largest magnitude: float32, 1e-4 (the
same function with sums in another order, through softmax, LayerNorm and up
to 5 layers; the largest seen is below 1e-5); bfloat16, 5e-2 (the packages
round to bf16 at other places — the port keeps the attention output and the
weights' casts where JAX fuses them — and a rounding flip moves a gradient by
a few bf16 ulps of its largest entry).  The AdamW step is compared where both
packages' gradients are above 1e-6 in magnitude or both exactly 0: Adam's
first step moves an entry by about ±lr whatever its size, so an entry that is
rounding noise may move either way.
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

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import gnn as jgnn
from repro.models import transformer as jtfm
from repro.train import loop as jloop
from repro.train import optim as jopt
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import GraphBatcher, TokenPipeline
from repro_torch.graph.generators import rmat
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.models import gnn
from repro_torch.models import transformer as tfm
from repro_torch.train import optim
from repro_torch.train.loop import make_train_step
from repro_torch.train.pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
LM = "llama3.2-3b"
REL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _close_rel(got: list, want: list, rel: float):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = float(np.abs(w).max()) + 1e-12
        assert float(np.abs(g - w).max()) <= rel * scale, (float(np.abs(g - w).max()), scale)


def _grads(loss_fn, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    for p in leaves:
        p.requires_grad_(False)
    return float(loss), [g.float().numpy() for g in grads]


def _one_step_matches(loss_fn, params, batch, jloss, jparams, jbatch):
    """One AdamW step in each package; params compared where both gradients
    are above 1e-6 or both exactly 0 (an embedding row not in the batch; see
    the module docstring)."""
    sched = lambda m: m.adamw(m.cosine_schedule(1e-2, 1, 3))  # noqa: E731
    jinit, jstep = jloop.make_train_step(jloss, sched(jopt))
    init, step = make_train_step(loss_fn, sched(optim))
    jg = [np.asarray(x, np.float32) for x in jax.tree.leaves(jax.grad(jloss)(jparams, jbatch))]
    _, tg = _grads(loss_fn, params, batch)
    keep = [((np.abs(a) > 1e-6) & (np.abs(b) > 1e-6)) | ((a == 0) & (b == 0)) for a, b in zip(jg, tg)]
    jstate, jm = jstep(jinit(jparams), jbatch)
    state, m = step(init(params), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
    compared = 0
    for t, j, k in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params), keep):
        compared += int(k.sum())
        np.testing.assert_allclose(t.detach().float().numpy()[k], np.asarray(j, np.float32)[k], rtol=1e-5, atol=1e-6)
    assert compared > 0.8 * sum(t.numel() for t in tree_leaves(state.params))


# ------------------------------------------------------------------ LM


def _lm_pair(dtype):
    jcfg = dataclasses.replace(jax_get_arch(LM).smoke_config(), dtype=JAX_DTYPE[dtype])
    cfg = dataclasses.replace(get_arch(LM).smoke_config(), dtype=dtype)
    jparams = jtfm.init_params(jcfg, jax.random.key(0))
    params = interop.transformer_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    host = next(iter(TokenPipeline(cfg.vocab, 16, 2, seed=0)))
    return jcfg, jparams, cfg, params, host


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_loss_and_gradients_match_jax_grad(dtype):
    jcfg, jparams, cfg, params, host = _lm_pair(dtype)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jtfm.loss_fn(p, jbatch, jcfg))(jparams)
    loss, grads = _grads(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=REL[dtype] / 10, atol=REL[dtype] / 10)
    _close_rel(grads, jax.tree.leaves(jgrads), REL[dtype])


def test_lm_adamw_step_matches_the_reference():
    jcfg, jparams, cfg, params, host = _lm_pair(torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    _one_step_matches(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch,
                      lambda p, b: jtfm.loss_fn(p, b, jcfg), jparams, jbatch)


def test_lm_recompute_and_layer_split_leave_the_gradients_alone():
    """`remat` (per-layer checkpointing) and the split of the stacked leaves
    (`_layers`: one `unbind` a leaf) change where the work happens, not the
    gradients: equal to those without recompute and with per-layer indexing."""
    _, _, cfg, params, host = _lm_pair(torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    _, with_remat = _grads(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    _, without = _grads(lambda p, b: tfm.loss_fn(p, b, dataclasses.replace(cfg, remat=False)), params, batch)
    for a, b in zip(with_remat, without):
        np.testing.assert_array_equal(a, b)
    unbind = tfm._layers
    try:
        tfm._layers = lambda p, n: [tfm._layer(p, i) for i in range(n)]
        _, indexed = _grads(lambda p, b: tfm.loss_fn(p, b, cfg), params, batch)
    finally:
        tfm._layers = unbind
    for a, b in zip(with_remat, indexed):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------------ GNN


def _gnn_pair(arch, *, full_width=False, reduce_impl="ell"):
    jarch, tarch = jax_get_arch(arch), get_arch(arch)
    jcfg = jarch.model_config("full_graph_sm") if full_width else jarch.smoke_config()
    cfg = tarch.model_config("full_graph_sm") if full_width else tarch.smoke_config()
    cfg = dataclasses.replace(cfg, reduce_impl=reduce_impl)
    jparams = jgnn.init_params(jcfg, jax.random.key(0))
    params = interop.gnn_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    host = GraphBatcher(rmat(512, 4096, seed=0), d_feat=cfg.d_in, n_classes=max(cfg.d_out, 2)).full_batch()
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    if cfg.kind == "gin" and reduce_impl == "ell":
        batch["ell"] = gnn.batch_ell(host, device="cpu", transpose=True)
    return jcfg, jparams, cfg, params, batch, {k: jnp.asarray(v) for k, v in host.items()}


GNN_CASES = [("gin-tu", False, "ell"), ("gin-tu", False, "scatter"), ("gat-cora", False, "ell"),
             ("pna", False, "ell"), ("gin-tu", True, "ell")]


@pytest.mark.parametrize("arch,full_width,reduce_impl", GNN_CASES)
def test_gnn_loss_and_gradients_match_jax_grad(arch, full_width, reduce_impl):
    jcfg, jparams, cfg, params, batch, jbatch = _gnn_pair(arch, full_width=full_width, reduce_impl=reduce_impl)
    src, dst = batch["src"].numpy(), batch["dst"].numpy()
    assert np.unique(np.stack([src, dst]), axis=1).shape[1] < src.size  # multi-edges: PNA's max/min tie
    jloss, jgrads = jax.value_and_grad(lambda p: jgnn.loss_fn(p, jbatch, jcfg))(jparams)
    before = segment_spmm.launches
    loss, grads = _grads(lambda p, b: gnn.loss_fn(p, b, cfg), params, batch)
    assert segment_spmm.launches == before  # the host: the plain versions
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5, atol=1e-5)
    _close_rel(grads, jax.tree.leaves(jgrads), REL[torch.float32])


@pytest.mark.parametrize("arch", ["gin-tu", "gat-cora", "pna"])
def test_gnn_adamw_step_matches_the_reference(arch):
    jcfg, jparams, cfg, params, batch, jbatch = _gnn_pair(arch)
    _one_step_matches(lambda p, b: gnn.loss_fn(p, b, cfg), params, batch,
                      lambda p, b: jgnn.loss_fn(p, b, jcfg), jparams, jbatch)


# ------------------------------------------------------------------ the CLI on the host


def _cli(*argv):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv], capture_output=True,
                          text=True, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                                    "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("argv", [
    ("--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps", "2", "--seq", "16"),
    ("--arch", "gin-tu", "--smoke", "--device", "cpu", "--steps", "2"),
])
def test_train_cli_on_the_host_trains_the_lm_and_gnn_families(argv):
    done = _cli(*argv)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "[train] done at step 2" in done.stdout


def test_train_cli_refuses_graphcast_as_the_reference_does():
    done = _cli("--arch", "graphcast", "--smoke", "--device", "cpu", "--steps", "1")
    assert done.returncode == 1
    assert "use examples/graphcast_regression.py for graphcast training" in done.stderr
