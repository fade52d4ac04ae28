"""The windowed NoC replay of `repro_torch.nocsim` against `repro.nocsim`, on the
CPU: the same seeded numpy traffic and placements go through both packages.

* `build_schedule` / `build_credit_program`: equal arrays.
* Open arm: the torch stepper's timelines equal `repro`'s numpy stepper bit
  for bit (add/min/sub round the same way), at every chunk size.
* Credit arm: every state timeline (serviced / eff_backlog / buf / src /
  admitted / arrivals) and the final carry within 1e-12 relative of `repro`'s
  numpy stepper — relative to the timeline's peak, since a backlog that
  drains to ~0 keeps a residue of the order of its peak's last bit; the
  contractions sum in another order.  At `buffer_depth=inf` the torch credit
  run equals the torch open run bit for bit.
* `contended_batch`, `simulate_contended`, `simulate(contention=)` and
  `contention_sweep_payload`: equal records; the frozen golden contention
  slice is reproduced through the port's `run_sweep`.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.nocsim as jnocsim
from _hypothesis_compat import given, settings, st
from repro.nocsim.model import build_schedule as jax_build_schedule
import repro_torch.core as core
import repro_torch.nocsim as nocsim
from repro_torch.experiments.grid import GRIDS
from repro_torch.experiments.sweep import run_sweep
from repro_torch.nocsim.batch import open_step, run_windows, stacked_open_program
from repro_torch.nocsim.model import build_schedule

TOPOLOGIES = [("mesh2d", (4, 4)), ("torus2d", (4, 4)), ("torus3d", (2, 2, 4))]
ROUTINGS = ["dor", "adaptive2"]
DEPTHS = [0.5, 1.0, 2.0, 8.0, float("inf")]
STATE_RTOL = 1e-12
W = 32
CHUNKS = [None, 1, W - 1, W]
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_contention_mesh2d.json"


def _bytes(parts: int, seed: int, density: float = 0.4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = 4 * parts
    m = (rng.random((n, n)) < density) * rng.integers(1, 2000, size=(n, n)).astype(np.float64)
    np.fill_diagonal(m, 0.0)
    return m


def _pair(name, dims, seed, parts=4):
    """(port traffic, port placement), (repro traffic, repro placement) on
    the same bytes and sites."""
    m = _bytes(parts, seed)
    site = np.random.default_rng(seed + 1).permutation(int(np.prod(dims)))[: 4 * parts].astype(np.int64)
    out = []
    for mod in (core, jcore):
        t = mod.TrafficMatrix(num_parts=parts, bytes_matrix=m.copy(),
                              phase_bytes={"process": float(m.sum()), "reduce": 0.0, "apply": 0.0})
        out.append((t, mod.Placement(mod.topology_by_name(name, *dims), site.copy(), "test")))
    return out


def _batch(name, dims, seeds=(0, 1)):
    mine, theirs = zip(*(_pair(name, dims, s) for s in seeds))
    return [list(x) for x in zip(*mine)], [list(x) for x in zip(*theirs)]


def _close(got, want, what=""):
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=STATE_RTOL, atol=STATE_RTOL * scale, err_msg=what)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_build_schedule_arrays_equal(name, dims, routing):
    (t, p), (jt, jp) = _pair(name, dims, seed=3)
    a = build_schedule(t, p, noc_params=nocsim.NocSimParams(routing=routing))
    b = jax_build_schedule(jt, jp, noc_params=jnocsim.NocSimParams(routing=routing))
    for f in dataclasses.fields(b):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(v, np.ndarray):
            assert u.dtype == v.dtype and np.array_equal(u, v), f.name
        else:
            assert u == v, f.name


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_open_arm_timelines_bit_equal(name, dims, routing, chunk):
    (ts, ps), (jts, jps) = _batch(name, dims)
    params = nocsim.NocSimParams(routing=routing)
    scheds = [build_schedule(t, p, noc_params=params) for t, p in zip(ts, ps)]
    jscheds = [jax_build_schedule(t, p, noc_params=jnocsim.NocSimParams(routing=routing))
               for t, p in zip(jts, jps)]
    inj = stacked_open_program(scheds, W)
    (want_s, want_b), want_carry = jnocsim.run_windows(jnocsim.open_step("numpy"), (inj,), None)
    for s, js in zip(scheds, jscheds):  # the program is the reference's bytes
        assert np.array_equal(s.inj, js.inj) and s.cap_bytes == js.cap_bytes
    (got_s, got_b), carry = run_windows(open_step("torch"), (torch.from_numpy(inj),), None,
                                        window_chunk=chunk)
    assert isinstance(got_s, torch.Tensor) and got_s.dtype == torch.float64
    assert np.array_equal(got_s.numpy(), want_s) and np.array_equal(got_b.numpy(), want_b)
    assert np.array_equal(carry.numpy(), want_carry)
    (np_s, np_b), _ = run_windows(open_step("numpy"), (inj,), None, window_chunk=chunk)
    assert np.array_equal(np_s, want_s) and np.array_equal(np_b, want_b)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), topo=st.sampled_from(TOPOLOGIES), chunk=st.integers(1, W))
def test_open_arm_bit_equal_on_random_traffic(seed, topo, chunk):
    name, dims = topo
    (t, p), (jt, jp) = _pair(name, dims, seed)
    a = nocsim.contended_batch([t], [p], backend="torch", device="cpu", window_chunk=chunk)[0]
    b = jnocsim.contended_batch([jt], [jp], backend="numpy")[0]
    assert {**a.to_dict(), "backend": "numpy"} == b.to_dict()
    assert np.array_equal(a.util_timeline, b.util_timeline)
    assert np.array_equal(a.link_peak_util, b.link_peak_util)


def _programs(name, dims, routing, depth):
    (ts, ps), (jts, jps) = _batch(name, dims)
    params = nocsim.NocSimParams(routing=routing, flow_control="credit", buffer_depth=depth)
    jparams = jnocsim.NocSimParams(routing=routing, flow_control="credit", buffer_depth=depth)
    scheds = [build_schedule(t, p, noc_params=params) for t, p in zip(ts, ps)]
    jscheds = [jax_build_schedule(t, p, noc_params=jparams) for t, p in zip(jts, jps)]
    return (nocsim.build_credit_program(scheds, params), scheds,
            jnocsim.build_credit_program(jscheds, jparams))


TIMELINES = ("serviced", "eff_backlog", "buf", "src", "admitted", "arrivals")


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_credit_arm_state_timelines_match(name, dims, routing, depth):
    prog, _, jprog = _programs(name, dims, routing, depth)
    for f in ("inj", "offered", "inc", "pair_c", "pair_l", "pair_f"):
        assert np.array_equal(getattr(prog, f), getattr(jprog, f)), f
    assert prog.depth == jprog.depth
    want, (wsrc, wbuf) = jnocsim.run_credit(jprog, backend="numpy")
    got, (src, buf) = nocsim.run_credit(prog, backend="torch", device="cpu")
    for f in TIMELINES:
        _close(getattr(got, f), getattr(want, f), f)
    _close(src, wsrc, "final src")
    _close(buf, wbuf, "final buf")
    # the torch arm's own numpy stepper is the reference's, bit for bit
    mine, _ = nocsim.run_credit(prog, backend="numpy")
    for f in TIMELINES:
        assert np.array_equal(getattr(mine, f), getattr(want, f)), f


@pytest.mark.parametrize("chunk", [1, W - 1, W])
@pytest.mark.parametrize("depth", [0.5, 2.0])
def test_credit_arm_chunking_is_bit_identical(depth, chunk):
    prog, _, _ = _programs("torus2d", (4, 4), "adaptive2", depth)
    whole, carry = nocsim.run_credit(prog, backend="torch", device="cpu")
    part, pcarry = nocsim.run_credit(prog, backend="torch", device="cpu", window_chunk=chunk)
    for f in TIMELINES:
        assert np.array_equal(getattr(part, f), getattr(whole, f)), f
    assert all(np.array_equal(a, b) for a, b in zip(pcarry, carry))


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_infinite_credit_equals_open_arm_on_torch(name, dims, routing):
    prog, scheds, _ = _programs(name, dims, routing, float("inf"))
    tl, _ = nocsim.run_credit(prog, backend="torch", device="cpu")
    (s, b), _ = run_windows(open_step("torch"), (torch.from_numpy(stacked_open_program(scheds, W)),), None)
    assert np.array_equal(tl.serviced, s.numpy()) and np.array_equal(tl.eff_backlog, b.numpy())
    assert np.array_equal(tl.buf, b.numpy()) and not tl.src.any()


@pytest.mark.parametrize("flow_control,depth", [("open", float("inf")), ("credit", 1.0), ("credit", float("inf"))])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_contended_batch_results_match(name, dims, flow_control, depth):
    (ts, ps), (jts, jps) = _batch(name, dims)
    kw = dict(flow_control=flow_control, buffer_depth=depth)
    got = nocsim.contended_batch(ts, ps, noc_params=nocsim.NocSimParams(**kw), backend="torch",
                                 device="cpu", num_iterations=[3, 5])
    want = jnocsim.contended_batch(jts, jps, noc_params=jnocsim.NocSimParams(**kw),
                                   backend="numpy", num_iterations=[3, 5])
    for a, b in zip(got, want):
        da, db = a.to_dict(), b.to_dict()
        assert da.pop("backend") == "torch" and db.pop("backend") == "numpy"
        for k, v in db.items():
            if isinstance(v, float) and flow_control == "credit":
                assert da[k] == pytest.approx(v, rel=1e-9, abs=0.0), k
            else:
                assert da[k] == v, k


@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_simulate_with_contention_matches(name, dims):
    (t, p), (jt, jp) = _pair(name, dims, seed=9)
    contention = nocsim.NocSimParams(profile="phases")
    a = core.simulate(t, p, num_iterations=4, contention=contention)
    b = jcore.simulate(jt, jp, num_iterations=4, contention=jnocsim.NocSimParams(profile="phases"))
    assert a.t_network_contended_s is not None
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    one = nocsim.simulate_contended(t, p, noc_params=contention, num_iterations=4)
    assert one.backend == "numpy" and one.t_network_contended_s == a.t_network_contended_s
    on_torch = nocsim.simulate_contended(t, p, noc_params=contention, num_iterations=4,
                                         backend="torch", device="cpu")
    assert on_torch.backend == "torch"
    assert on_torch.t_network_contended_s == a.t_network_contended_s


class _Cfg:
    def __init__(self, key):
        self.key = key


@dataclasses.dataclass
class _Axis:
    key: str
    topology: str


def test_contention_sweep_payload_records_equal():
    configs = [_Axis(key=f"cfg{i}", topology=n) for i, (n, _) in enumerate(TOPOLOGIES)]
    pairs = [_pair(n, d, seed=20 + i) for i, (n, d) in enumerate(TOPOLOGIES)]
    (ts, ps), (jts, jps) = ([list(x) for x in zip(*side)] for side in zip(*pairs))
    got = nocsim.contention_sweep_payload(configs, ts, ps, num_iterations=2,
                                          buffer_depths=(0.5, 4.0), device="cpu")
    want = jnocsim.contention_sweep_payload(configs, jts, jps, num_iterations=2,
                                            buffer_depths=(0.5, 4.0))
    assert got["records"] == want["records"]
    assert len(got["records"]) == len(TOPOLOGIES) * 2 * 3
    assert got["noc_params"] == want["noc_params"] and got["buffer_depths"] == [0.5, 4.0]
    assert got["backends"] == ["numpy", "torch"]
    assert got["credit_inf_numpy_max_abs"] == 0.0 and got["credit_inf_torch_max_rel"] == 0.0
    assert got["backend_parity_max_rel"] <= 1e-9
    assert "dor_credit_d0.5_torch_s" in got["timings"] and "credit_inf_jax_max_rel" not in got


def test_golden_contention_slice_is_reproduced():
    """`tests/fixtures/golden_contention_mesh2d.json` (frozen from the
    reference's open-loop stepper) through the port's `run_sweep`, every
    frozen field equal."""
    golden = json.loads(FIXTURE.read_text())
    g = golden["grid"]
    grid = dataclasses.replace(
        GRIDS["contention"], workloads=tuple(g["workloads"]), algorithms=tuple(g["algorithms"]),
        topologies=tuple(g["topologies"]), parts=tuple(g["parts"]), scale=g["scale"],
        placements=tuple(g["placements"]),
    )
    res = run_sweep(grid, device="cpu", measure_serial=False)
    got = {(r["key"], r["routing"]): r for r in res.contention["records"]}
    assert len(golden["records"]) == 4
    for ref in golden["records"]:
        rec = got[(ref["key"], ref["routing"])]
        for field, want in ref.items():
            assert rec[field] == want, (ref["key"], field)
    assert res.contention["backend_parity_max_rel"] <= 1e-9


def test_torch_arm_needs_a_device_it_can_use():
    (t, p), _ = _pair("mesh2d", (4, 4), seed=0)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nocsim.contended_batch([t], [p], backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nocsim.contention_sweep_payload([_Cfg("a")], [t], [p])
    with pytest.raises(ValueError, match="unknown backend"):
        nocsim.contended_batch([t], [p], backend="jax", device="cpu")
    # the numpy reference needs no device
    assert nocsim.contended_batch([t], [p], backend="numpy")[0].backend == "numpy"
