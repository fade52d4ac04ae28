"""The example twins `examples/torch_{quickstart,serve_continuous_batching,
train_lm_e2e}.py` on the CPU, each `main` called in process:

* torch_quickstart prints the reference example's lines, number for number;
* the serve twin's `serve`, fed the JAX package's weights carried over by
  `interop.transformer_params`, serves the tokens `repro`'s `build_engine`
  serves for the same 10 requests, and its `main` needs the card unless it
  is given `--device cpu`;
* torch_train_lm_e2e at a narrow width trains, checkpoints and resumes
  (`[resume] restored step N`), with and without `--moe`;
* no twin imports `jax` or `repro`.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import re
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.serve import build_engine as jax_build_engine
from repro.models import transformer as jtfm
from repro.serve.engine import Request as JaxRequest
from repro_torch import interop

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("torch_quickstart", "torch_serve_continuous_batching", "torch_train_lm_e2e")
NARROW = ["--width", "64", "--layers", "2", "--vocab", "512", "--seq", "32", "--batch", "2", "--device", "cpu"]


def example(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lines_of(capsys, fn) -> list[str]:
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", TWINS)
def test_no_twin_imports_jax_or_repro(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}


def test_quickstart_prints_the_reference_examples_lines(capsys):
    want = lines_of(capsys, lambda: runpy.run_path(str(EXAMPLES / "quickstart.py"), run_name="__main__"))
    got = lines_of(capsys, lambda: example("torch_quickstart").main(["--device", "cpu"]))
    assert got == want and len(got) == 5
    assert "converged in 38 iterations" in got[1] and got[2].startswith("avg hops: 5.25 → 1.04")


@pytest.mark.parametrize("name", TWINS)
def test_twins_need_the_card_unless_given_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])


def test_serve_gives_the_reference_engines_tokens_on_its_weights(capsys):
    mod = example("torch_serve_continuous_batching")
    cfg = mod.serve_config()
    jcfg = dataclasses.replace(jax_get_arch("llama3.2-3b").smoke_config(), n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads)
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    params = interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    engine, stats = mod.serve(cfg, params, "cpu")
    lines = capsys.readouterr().out.splitlines()

    jeng = jax_build_engine(jcfg, jp, slots=mod.SLOTS, max_seq=mod.MAX_SEQ)
    for uid, prompt in mod.requests(jcfg.vocab):
        jeng.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=mod.NEW_TOKENS))
    want = jeng.run_until_drained()
    assert [(r.uid, r.out_tokens) for r in engine.completed] == [(r.uid, r.out_tokens) for r in want]
    assert len(engine.completed) == mod.REQUESTS and stats["idle_steps"] == 0
    assert stats["tokens"] == sum(len(r.out_tokens) for r in want)
    assert re.match(rf"10 requests, {stats['tokens']} tokens, .* tok/s on the CPU; slots never idle while queue "
                    r"non-empty\)$", lines[-1])
    assert [line for line in lines if line.startswith("step ")][0] == "step   8: 4 active, 6 queued, 0 done"


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_train_checkpoints_and_resumes(tmp_path, capsys, moe):
    mod = example("torch_train_lm_e2e")
    argv = NARROW + ["--ckpt-dir", str(tmp_path)] + (["--moe"] if moe else [])
    first = lines_of(capsys, lambda: mod.main(argv + ["--steps", "11"]))
    assert first[0].startswith("model: ") and "(2L d=64 vocab=512)" in first[0]
    losses = [float(m.group(1)) for m in (re.match(r"\[step \d+\] loss=(\S+) ", x) for x in first) if m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert first[-1] == f"done at step 11; checkpoints in {tmp_path}"
    assert (tmp_path / "step_11").is_dir()
    second = lines_of(capsys, lambda: mod.main(argv + ["--steps", "13"]))
    assert "[resume] restored step 11" in second
    assert second[-1] == f"done at step 13; checkpoints in {tmp_path}"
