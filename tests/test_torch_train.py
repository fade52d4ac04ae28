"""The port's training substrate against the JAX package's on the same
inputs: `data.pipeline` (bit-equal batches for a seed), `train.optim`
(AdamW, SGD, schedules, clipping, int8 compression on one pytree),
`train.checkpoint` (the same files, keys and checksums), `train.loop`
(three steps of the smoke dcn-v2, resume, SIGTERM), and the
`launch.train` driver on the host."""
import itertools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.data import pipeline as jpipe
from repro.models import recsys as jrec
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optim as jopt
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as pipe
from repro_torch.launch.train import train
from repro_torch.models import recsys as rec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim
from repro_torch.train.loop import TrainLoop, make_train_step
from repro_torch.train.pytree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-5, atol=1e-7)  # the same float32 arithmetic, another rounding order


def _tree(seed=0, scale=1.0):
    """One pytree of every shape kind the params have: a dict of a matrix and
    a list of dicts."""
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "b": [{"c": (scale * rng.standard_normal(5)).astype(np.float32)},
                  {"c": (scale * rng.standard_normal((2, 2))).astype(np.float32)}]}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(t_tree, j_tree, tol=OPT_TOL):
    for t, j in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ------------------------------------------------------------------ pipelines


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_recsys_batches_are_bit_equal(multi_hot):
    args = (13, 26, 1000, 32)
    ours = itertools.islice(iter(pipe.RecsysPipeline(*args, multi_hot=multi_hot, seed=4)), 3)
    ref = itertools.islice(iter(jpipe.RecsysPipeline(*args, multi_hot=multi_hot, seed=4)), 3)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_token_batches_and_host_slice_are_equal():
    for a, b in zip(itertools.islice(iter(pipe.TokenPipeline(512, 16, 4, seed=1)), 3),
                    itertools.islice(iter(jpipe.TokenPipeline(512, 16, 4, seed=1)), 3)):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    for args in ((64, 0, 4), (64, 3, 4), (10, 1, 3)):
        assert pipe.host_slice(*args) == jpipe.host_slice(*args)


def test_prefetcher_keeps_the_order_and_closes():
    got = list(pipe.Prefetcher(iter(range(10)), depth=2))
    assert got == list(range(10))
    endless = pipe.Prefetcher(itertools.count(), depth=2)
    assert [next(endless) for _ in range(3)] == [0, 1, 2]
    endless.close()
    assert not endless._t.is_alive()


def test_to_device_keeps_values_and_types():
    batch = next(iter(pipe.RecsysPipeline(4, 3, 100, 8)))
    out = pipe.to_device(batch, "cpu")
    for k, v in batch.items():
        assert isinstance(out[k], torch.Tensor) and out[k].numpy().dtype == v.dtype
        assert np.array_equal(out[k].numpy(), v)


# ------------------------------------------------------------------ optimizer


def test_schedules_match_the_reference():
    cos, jcos = optim.cosine_schedule(1e-3, 10, 50), jopt.cosine_schedule(1e-3, 10, 50)
    assert cos(0) == 0.0  # lr is taken before the increment: step 0 does nothing
    for s in range(0, 60, 3):
        np.testing.assert_allclose(cos(s), float(jcos(s)), rtol=1e-6)
    lw, jlw = optim.linear_warmup(0.5, 4), jopt.linear_warmup(0.5, 4)
    for s in range(8):
        np.testing.assert_allclose(lw(s), float(jlw(s)), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above the clip norm
def test_clip_by_global_norm_matches_the_reference(scale):
    g = _tree(1, scale)
    jc, jn = jopt.clip_by_global_norm(_to_jax(g), 1.0)
    tc, tn = optim.clip_by_global_norm(_to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tc, jc)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_steps_match_the_reference(name):
    make = {"adamw": lambda m: m.adamw(m.cosine_schedule(1e-2, 2, 6)),
            "sgd": lambda m: m.sgd(m.cosine_schedule(1e-2, 2, 6))}[name]
    o, jo = make(optim), make(jopt)
    p, jp = _to_torch(_tree(0)), _to_jax(_tree(0))
    s, js = o.init(p), jo.init(jp)
    for step in range(6):
        g = _tree(10 + step, 3.0)  # large enough for AdamW to clip
        p, s = o.update(_to_torch(g), s, p, step)
        jp, js = jo.update(_to_jax(g), js, jp, step)
    _close(p, jp)
    for key in s:
        _close(s[key], js[key])


def test_int8_compression_matches_the_reference():
    res = optim.Int8State(_to_torch(tree_map(np.zeros_like, _tree(0))))
    jres = jopt.Int8State(_to_jax(tree_map(np.zeros_like, _tree(0))))
    for k in range(5):
        g = _tree(20 + k)
        deq, res = optim.int8_compress(_to_torch(g), res)
        jdeq, jres = jopt.int8_compress(_to_jax(g), jres)
        _close(deq, jdeq)
        _close(res.residual, jres.residual)


# ------------------------------------------------------------------ three train steps


def test_three_steps_of_the_smoke_dcn_v2_match_the_reference():
    """Losses within 1e-5; params within 1e-5 where, at every step, the
    gradient is above rounding noise (|g| > 1e-8) in both packages or exactly
    0 in both (a row not looked up in that batch).  The rest is left out:
    Adam's m/√v turns a ±1e-10 gradient into a ±1 step, so those entries may
    move either way."""
    jcfg, cfg = jax_get_arch("dcn-v2").smoke_config(), get_arch("dcn-v2").smoke_config()
    jparams = jrec.init_params(jcfg, jax.random.key(0))
    params = interop.recsys_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    batches = list(itertools.islice(iter(pipe.RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table,
                                                             64, seed=0)), 3))
    jloss = lambda q, b: jrec.loss_fn(q, b, jcfg)  # noqa: E731
    jinit, jstep = jloop.make_train_step(jloss, jopt.adamw(jopt.cosine_schedule(1e-2, 1, 3)))
    init, step = make_train_step(lambda q, b: rec.loss_fn(q, b, cfg),
                                 optim.adamw(optim.cosine_schedule(1e-2, 1, 3)))
    jstate, state = jinit(jparams), init(params)
    keep = None
    for b in batches:
        jb = _to_jax(b)
        jg = jax.tree.leaves(jax.grad(jloss)(jstate.params, jb))
        for p in tree_leaves(state.params):
            p.requires_grad_(True)
        tg = torch.autograd.grad(rec.loss_fn(state.params, b, cfg), tree_leaves(state.params))
        ok = [((np.abs(np.asarray(x)) > 1e-8) & (y.abs().numpy() > 1e-8)) | ((np.asarray(x) == 0) & (y.numpy() == 0))
              for x, y in zip(jg, tg)]
        keep = ok if keep is None else [u & v for u, v in zip(keep, ok)]
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
    assert state.step == 3
    compared = 0
    for t, j, k in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params), keep):
        compared += int(k.sum())
        np.testing.assert_allclose(t.detach().numpy()[k], np.asarray(j)[k], rtol=1e-5, atol=1e-7)
    assert compared > 0.9 * sum(t.numel() for t in tree_leaves(state.params))


# ------------------------------------------------------------------ checkpoints


def test_checkpoint_files_equal_the_reference(tmp_path):
    tree = {"params": _tree(3), "step": np.int32(7)}
    ckpt.save_checkpoint(str(tmp_path / "t"), 7, {"params": _to_torch(tree["params"]),
                                                  "step": torch.tensor(7, dtype=torch.int32)})
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, {"params": _to_jax(tree["params"]), "step": jnp.int32(7)})
    mt = json.loads((tmp_path / "t" / "step_7" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "step_7" / "manifest.json").read_text())
    assert mt["leaves"] == mj["leaves"]  # keys, files, shapes, dtypes, crc32
    assert sorted(mt["leaves"]) == ["params/a", "params/b/0/c", "params/b/1/c", "step"]
    assert ckpt.latest_step(str(tmp_path / "t")) == jckpt.latest_step(str(tmp_path / "j")) == 7
    # each package restores what the other wrote
    back, s = ckpt.restore_checkpoint(str(tmp_path / "j"), {"params": _to_torch(tree["params"]),
                                                             "step": torch.tensor(0)})
    assert s == 7 and int(back["step"]) == 7
    _close(back["params"], _to_jax(tree["params"]), dict(rtol=0, atol=0))


def test_checkpoint_roundtrip_latest_and_corruption(tmp_path):
    tree = {"x": torch.arange(8, dtype=torch.float32), "y": [torch.ones(2, 3)]}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    thread = ckpt.save_checkpoint(str(tmp_path), 2, tree_map(lambda t: t * 2, tree), blocking=False)
    thread.join()
    assert ckpt.latest_step(str(tmp_path)) == 2
    back, s = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert s == 2 and torch.equal(back["x"], 2 * tree["x"]) and isinstance(back["y"], list)
    back, s = ckpt.restore_checkpoint(str(tmp_path), tree, step=1)
    assert s == 1 and torch.equal(back["y"][0], tree["y"][0])
    f = tmp_path / "step_1" / "x.npy"
    data = bytearray(f.read_bytes())
    data[-4] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError):
        ckpt.restore_checkpoint(str(tmp_path), tree, step=1)
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path), {"z": torch.zeros(1)})


def test_async_save_copies_before_the_params_change(tmp_path):
    p = torch.zeros(1000)
    thread = ckpt.save_checkpoint(str(tmp_path), 1, {"p": p}, blocking=False)
    p.add_(1.0)  # the optimizer's in-place update right after
    thread.join()
    back, _ = ckpt.restore_checkpoint(str(tmp_path), {"p": p})
    assert float(back["p"].abs().sum()) == 0.0


def test_checkpointer_gc_keeps_the_latest(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path), every=1, keep=2)
    for s in range(1, 6):
        ck.maybe_save(s, {"x": torch.zeros(1)})
    ck.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(steps) <= 3 and 5 in steps


# ------------------------------------------------------------------ loop and driver


def _quadratic():
    def loss(p, b):
        return torch.mean((p["w"] @ b["x"] - b["y"]) ** 2)

    init, step = make_train_step(loss, optim.adamw(1e-2))
    return init({"w": torch.ones((2, 2))}), step, {"x": torch.ones((2, 4)), "y": torch.zeros((2, 4))}


def test_resume_continues_the_step_count(tmp_path):
    state, step, batch = _quadratic()
    ck = ckpt.Checkpointer(str(tmp_path), every=5)
    seen = []
    loop = TrainLoop(step, checkpointer=ck, log_fn=lambda s: None, on_step=lambda st, m, b: seen.append(m["step"]))
    state = loop.run(state, itertools.repeat(batch), num_steps=10)
    assert state.step == 10 and seen == list(range(10))
    w_after = state.params["w"].detach().clone()
    state2, step2, _ = _quadratic()
    logs = []
    state2 = TrainLoop(step2, checkpointer=ck, log_fn=logs.append).run(state2, itertools.repeat(batch), num_steps=10)
    assert state2.step == 10 and logs == ["[resume] restored step 10"]  # restored, not retrained
    assert torch.equal(state2.params["w"].detach(), w_after)


def test_sigterm_writes_a_final_checkpoint_and_exits_143(tmp_path):
    state, step, batch = _quadratic()
    previous = signal.getsignal(signal.SIGTERM)

    def step_then_preempt(st, b):
        st, m = step(st, b)
        if m["step"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return st, m

    loop = TrainLoop(step_then_preempt, checkpointer=ckpt.Checkpointer(str(tmp_path), every=100),
                     log_fn=lambda s: None)
    with pytest.raises(SystemExit) as exc:
        loop.run(state, itertools.repeat(batch), num_steps=10)
    assert exc.value.code == 143 and ckpt.latest_step(str(tmp_path)) == 3
    assert signal.getsignal(signal.SIGTERM) == previous  # the loop's handler is gone again


def test_train_driver_on_the_host_resumes(tmp_path):
    logs = []
    state = train("dcn-v2", smoke=True, steps=4, batch=16, device="cpu", ckpt_dir=str(tmp_path),
                  ckpt_every=2, log_fn=logs.append)
    assert state.step == 4 and ckpt.latest_step(str(tmp_path)) == 4
    assert logs[0].startswith("[train] dcn-v2 family=recsys params=13,897")
    logs.clear()
    train("dcn-v2", smoke=True, steps=4, batch=16, device="cpu", ckpt_dir=str(tmp_path), log_fn=logs.append)
    assert "[resume] restored step 4" in logs
    # the LM and GNN families train too (their kernels have a backward), and resume the same way
    for arch in ("llama3.2-3b", "gin-tu"):
        d = tmp_path / arch
        state = train(arch, smoke=True, steps=2, seq=16, device="cpu", ckpt_dir=str(d), ckpt_every=1,
                      log_fn=lambda _: None)
        assert state.step == 2 and ckpt.latest_step(str(d)) == 2
        logs.clear()
        train(arch, smoke=True, steps=2, seq=16, device="cpu", ckpt_dir=str(d), log_fn=logs.append)
        assert "[resume] restored step 2" in logs


def test_train_cli_on_the_host_exits_0():
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dcn-v2", "--smoke", "--device", "cpu",
         "--steps", "3"],
        capture_output=True, text=True, cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=300,
    )
    assert done.returncode == 0, done.stderr
    assert "[train] done at step 3" in done.stdout
