"""The port's serving engine (`repro_torch.launch.serve.build_engine`) against
the JAX package's on the smoke llama3.2-3b with the same weights: the same
requests drain in the same order with the same greedy tokens."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.serve import build_engine as jax_build_engine
from repro.models import transformer as jtfm
from repro.serve.engine import Request as JaxRequest
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.launch.serve import build_engine
from repro_torch.serve.engine import Request

ARCH = "llama3.2-3b"


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_arch(ARCH).smoke_config()
    cfg = get_arch(ARCH).smoke_config()
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, cfg, interop.transformer_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _drain(weights, *, slots, max_seq, prompts, max_new):
    jcfg, jp, cfg, p = weights
    jeng = jax_build_engine(jcfg, jp, slots=slots, max_seq=max_seq)
    eng = build_engine(cfg, p, slots=slots, max_seq=max_seq, device="cpu")
    for i, prompt in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=prompt, max_new_tokens=max_new))
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
    return jeng.run_until_drained(), eng.run_until_drained(), eng


def test_five_requests_give_the_jax_tokens(weights):
    """tests/test_train_substrate.py:148's traffic: 5 requests, 2 slots."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 100, 5).astype(np.int32) for _ in range(5)]
    want, got, eng = _drain(weights, slots=2, max_seq=32, prompts=prompts, max_new=4)
    assert len(got) == 5 and all(r.done for r in got)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 4 or r.out_tokens[-1] == eng.eos_id for r in got)
    assert eng.cache["k"].dtype == torch.float32  # as the JAX driver's cache


def test_ragged_prompts_give_the_jax_tokens(weights):
    """Prompts of different lengths over 3 slots, slots freed and refilled
    in a ragged order; the longest prompt fills max_seq exactly."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 512, n).astype(np.int32) for n in (3, 11, 7, 16, 5, 14, 9)]
    want, got, _ = _drain(weights, slots=3, max_seq=24, prompts=prompts, max_new=8)
    assert [(r.uid, r.out_tokens) for r in got] == [(r.uid, r.out_tokens) for r in want]
    assert all(len(r.out_tokens) == 8 or r.out_tokens[-1] == 1 for r in got)


def test_admission_rules(weights):
    _, _, cfg, p = weights
    eng = build_engine(cfg, p, slots=1, max_seq=10, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(uid=0, prompt=np.arange(2, 9, dtype=np.int32), max_new_tokens=4))
    assert eng.run_until_drained() == []


def test_main_serves_the_smoke_model(capsys):
    serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2", "--max-new", "3", "--device", "cpu"])
    assert "[serve] 3 requests" in capsys.readouterr().out
