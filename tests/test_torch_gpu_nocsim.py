"""The windowed NoC replay's torch steppers on the card against the port's own
float64 numpy steppers (the reference's, bit for bit: `tests/test_torch_nocsim.py`).

Every test here carries the `gpu` marker and skips on a machine without a
CUDA device.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_nocsim.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as core
import repro_torch.faults as faults
import repro_torch.nocsim as nocsim
from repro_torch.nocsim.batch import open_step, run_windows, stacked_open_program
from repro_torch.nocsim.model import build_schedule

TOPOLOGIES = [("mesh2d", (4, 4)), ("torus2d", (4, 4)), ("torus3d", (2, 2, 4))]
W = 32
CREDIT_RTOL = 1e-12  # relative to each timeline's peak: the contractions sum in another order
TIMELINES = ("serviced", "eff_backlog", "buf", "src", "admitted", "arrivals")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the torch arm under test runs on the card")


def _batch(name, dims, seeds=(0, 1), parts=4):
    ts, ps = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        n = 4 * parts
        m = (rng.random((n, n)) < 0.4) * rng.integers(1, 2000, size=(n, n)).astype(np.float64)
        np.fill_diagonal(m, 0.0)
        ts.append(core.TrafficMatrix(num_parts=parts, bytes_matrix=m, phase_bytes={}))
        site = np.random.default_rng(seed + 1).permutation(int(np.prod(dims)))[:n]
        ps.append(core.Placement(core.topology_by_name(name, *dims), site, "test"))
    return ts, ps


def _close(got, want):
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=CREDIT_RTOL, atol=CREDIT_RTOL * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 1, W - 1, W])
@pytest.mark.parametrize("routing", ["dor", "adaptive2"])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_open_arm_on_the_card_equals_numpy_bit_for_bit(name, dims, routing, chunk):
    _need_card()
    ts, ps = _batch(name, dims)
    params = nocsim.NocSimParams(routing=routing)
    inj = stacked_open_program([build_schedule(t, p, noc_params=params) for t, p in zip(ts, ps)], W)
    (s_np, b_np), c_np = run_windows(open_step("numpy"), (inj,), None)
    (s, b), c = run_windows(open_step("torch"), (torch.from_numpy(inj).cuda(),), None, window_chunk=chunk)
    assert s.is_cuda and c.is_cuda
    assert np.array_equal(s.cpu().numpy(), s_np) and np.array_equal(b.cpu().numpy(), b_np)
    assert np.array_equal(c.cpu().numpy(), c_np)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0.5, 1.0, 2.0, 8.0, float("inf")])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_credit_arm_on_the_card_matches_numpy(name, dims, depth):
    _need_card()
    ts, ps = _batch(name, dims)
    params = nocsim.NocSimParams(routing="adaptive2", flow_control="credit", buffer_depth=depth)
    scheds = [build_schedule(t, p, noc_params=params) for t, p in zip(ts, ps)]
    prog = nocsim.build_credit_program(scheds, params)
    want, wcarry = nocsim.run_credit(prog, backend="numpy")
    got, carry = nocsim.run_credit(prog, backend="torch", device="cuda")
    for f in TIMELINES:
        _close(getattr(got, f), getattr(want, f))
    for a, b in zip(carry, wcarry):
        _close(a, b)
    for chunk in (1, W - 1):
        part, _ = nocsim.run_credit(prog, backend="torch", device="cuda", window_chunk=chunk)
        assert all(np.array_equal(getattr(part, f), getattr(got, f)) for f in TIMELINES)
    if depth == float("inf"):
        (s, b), _ = run_windows(open_step("torch"), (torch.from_numpy(stacked_open_program(scheds, W)).cuda(),), None)
        assert np.array_equal(got.serviced, s.cpu().numpy()) and np.array_equal(got.eff_backlog, b.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_degraded_replay_on_the_card(name, dims, rate):
    _need_card()
    ts, ps = _batch(name, dims)
    fs = faults.sample_link_faults(ps[0].topology, rate, seed=3, derate_frac=0.2)
    for fc, exact in (("open", True), ("credit", False)):
        params = nocsim.NocSimParams(flow_control=fc, buffer_depth=2.0)
        got = faults.degraded_batch(ts, ps, [fs, fs], noc_params=params, backend="torch", device="cuda")
        want = faults.degraded_batch(ts, ps, [fs, fs], noc_params=params, backend="numpy")
        for a, b in zip(got, want):
            if exact:
                assert a.t_network_contended_s == b.t_network_contended_s
                assert np.array_equal(a.util_timeline, b.util_timeline)
            else:
                assert a.t_network_contended_s == pytest.approx(b.t_network_contended_s, rel=1e-9, abs=0)
