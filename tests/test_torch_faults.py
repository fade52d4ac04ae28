"""Fault injection of `repro_torch.faults` against `repro.faults`, on the CPU:
the numpy modules (fault sampling, fault-aware routing, evacuation and
repair) give equal results per seed; the degraded windowed replay
(`degraded_batch`) on the torch steppers equals `repro`'s numpy replay — the
open arm bit for bit, the credit arm within 1e-9 relative — an empty
`FaultSet` reproduces `contended_batch` bit for bit, and the degraded credit
arm at infinite depth reproduces the degraded open arm."""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.faults as jfaults
import repro.nocsim as jnocsim
from _hypothesis_compat import given, settings, st
import repro_torch.core as core
import repro_torch.faults as faults
import repro_torch.nocsim as nocsim
from repro_torch.experiments.placement_batch import repair_batch
from repro_torch.faults.repair import evacuate_placement, repair_descend
from repro_torch.core.placement import symmetrize_weights

TOPOLOGIES = [("mesh2d", (4, 4)), ("torus2d", (4, 4)), ("torus3d", (2, 2, 4))]
RATES = [0.0, 0.05, 0.1, 0.2]
REL = 1e-9


def _bytes(parts: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = 4 * parts
    m = (rng.random((n, n)) < 0.4) * rng.integers(1, 2000, size=(n, n)).astype(np.float64)
    np.fill_diagonal(m, 0.0)
    return m


def _pair(name, dims, seed, parts=4):
    m = _bytes(parts, seed)
    site = np.random.default_rng(seed + 1).permutation(int(np.prod(dims)))[: 4 * parts].astype(np.int64)
    out = []
    for mod in (core, jcore):
        t = mod.TrafficMatrix(num_parts=parts, bytes_matrix=m.copy(),
                              phase_bytes={"process": float(m.sum()), "reduce": 0.0, "apply": 0.0})
        out.append((t, mod.Placement(mod.topology_by_name(name, *dims), site.copy(), "test")))
    return out


def _faults_pair(topo_name, dims, rate, seed, **kw):
    return (faults.sample_link_faults(core.topology_by_name(topo_name, *dims), rate, seed=seed, **kw),
            jfaults.sample_link_faults(jcore.topology_by_name(topo_name, *dims), rate, seed=seed, **kw))


def _same_faultset(a, b):
    assert a.dead_links == b.dead_links
    assert a.derated_links == b.derated_links
    assert a.dead_tiles == b.dead_tiles


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_link_fault_samples_equal(name, dims, rate):
    for seed in (0, 1, 7):
        a, b = _faults_pair(name, dims, rate, seed)
        _same_faultset(a, b)
        assert a.num_dead_links() == b.num_dead_links() and a.describe() == b.describe()
    a, b = _faults_pair(name, dims, rate, 3, derate_frac=0.25, derate_gamma=0.5)
    _same_faultset(a, b)


@pytest.mark.parametrize("num_dead", [1, 2, 3])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_tile_fault_samples_equal(name, dims, num_dead):
    for seed in (0, 5):
        a = faults.sample_tile_faults(core.topology_by_name(name, *dims), num_dead, seed=seed)
        b = jfaults.sample_tile_faults(jcore.topology_by_name(name, *dims), num_dead, seed=seed)
        _same_faultset(a, b)


@pytest.mark.parametrize("name,dims", TOPOLOGIES + [("fbutterfly", (4, 4))])
def test_empty_faultset_routes_are_the_pristine_routes(name, dims):
    topo = core.topology_by_name(name, *dims)
    coords = topo.coords()
    for a in range(topo.num_nodes):
        for b in range(topo.num_nodes):
            ca, cb = tuple(coords[a]), tuple(coords[b])
            assert faults.route_links_faulty(topo, ca, cb, faults.FaultSet()) == topo.route_links(ca, cb)
    np.testing.assert_array_equal(
        faults.degraded_distance_matrix(topo, faults.FaultSet()), topo.distance_matrix())


@pytest.mark.parametrize("rate", [0.05, 0.2])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_faulty_routes_and_distances_equal(name, dims, rate):
    fa, fb = _faults_pair(name, dims, rate, seed=11)
    ta, tb = core.topology_by_name(name, *dims), jcore.topology_by_name(name, *dims)
    np.testing.assert_array_equal(faults.degraded_distance_matrix(ta, fa),
                                  jfaults.degraded_distance_matrix(tb, fb))
    assert faults.surviving_link_keys(ta, fa) == jfaults.surviving_link_keys(tb, fb)
    coords = ta.coords()
    for a in range(0, ta.num_nodes, 3):
        for b in range(ta.num_nodes):
            ca, cb = tuple(coords[a]), tuple(coords[b])
            route = faults.route_links_faulty(ta, ca, cb, fa)
            assert route == jfaults.route_links_faulty(tb, ca, cb, fb)
            assert not set(route) & faults.routing.effective_dead_links(ta, fa)


@pytest.mark.parametrize("budget", [0, 8, 32])
@pytest.mark.parametrize("name,dims", [("mesh2d", (4, 5)), ("torus2d", (4, 5))])
def test_evacuation_and_repair_equal(name, dims, budget):
    m = _bytes(4, seed=2)
    site = np.random.default_rng(4).permutation(int(np.prod(dims)))[:16].astype(np.int64)
    ta, tb = core.topology_by_name(name, *dims), jcore.topology_by_name(name, *dims)
    pa, pb = core.Placement(ta, site.copy(), "quad"), jcore.Placement(tb, site.copy(), "quad")
    fa = faults.sample_tile_faults(ta, 3, seed=9)
    fb = jfaults.sample_tile_faults(tb, 3, seed=9)
    np.testing.assert_array_equal(faults.evacuate_placement(pa, m, fa), jfaults.evacuate_placement(pb, m, fb))
    ra, rep_a = faults.repair_placement(pa, m, fa, budget=budget)
    rb, rep_b = jfaults.repair_placement(pb, m, fb, budget=budget)
    np.testing.assert_array_equal(ra.site, rb.site)
    assert ra.method == rb.method and rep_a.to_dict() == rep_b.to_dict()
    # the stacked engine of the port, torch backend, replays the serial descent
    d = faults.degraded_distance_matrix(ta, fa)
    blocked = np.zeros(ta.num_nodes, dtype=bool)
    blocked[list(fa.dead_tiles)] = True
    evac = evacuate_placement(pa, m, fa)
    (sites,), _ = repair_batch([m], [d], [evac], [blocked], max_steps=budget, backend="torch", device="cpu")
    serial, _ = repair_descend(symmetrize_weights(m), d, evac, blocked, budget)
    np.testing.assert_array_equal(sites, serial)


@pytest.mark.parametrize("routing_rate", [0.05, 0.15])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_degraded_schedules_equal(name, dims, routing_rate):
    (t, p), (jt, jp) = _pair(name, dims, seed=4)
    fa, fb = _faults_pair(name, dims, routing_rate, seed=6, derate_frac=0.2)
    a = faults.build_degraded_schedule(t, p, fa)
    b = jfaults.build_degraded_schedule(jt, jp, fb)
    assert (a.fail_window, a.redistribution, a.num_detoured_flows, a.detour_stretch) == (
        b.fail_window, b.redistribution, b.num_detoured_flows, b.detour_stretch)
    np.testing.assert_array_equal(a.route_inc_pre, b.route_inc_pre)
    np.testing.assert_array_equal(a.gamma, b.gamma)
    for f in dataclasses.fields(b.schedule):
        u, v = getattr(a.schedule, f.name), getattr(b.schedule, f.name)
        assert np.array_equal(u, v) if isinstance(v, np.ndarray) else u == v, f.name


def _degraded(name, dims, rate, seed, *, flow_control="open", depth=float("inf"), fail_window=None):
    pairs = [_pair(name, dims, seed=seed + k) for k in range(2)]
    (ts, ps), (jts, jps) = ([list(x) for x in zip(*side)] for side in zip(*pairs))
    fa, fb = _faults_pair(name, dims, rate, seed=seed + 100, derate_frac=0.1)
    kw = dict(flow_control=flow_control, buffer_depth=depth)
    got = faults.degraded_batch(ts, ps, [fa, fa], noc_params=nocsim.NocSimParams(**kw), backend="torch",
                                device="cpu", num_iterations=[2, 3], fail_window=fail_window)
    want = jfaults.degraded_batch(jts, jps, [fb, fb], noc_params=jnocsim.NocSimParams(**kw),
                                  backend="numpy", num_iterations=[2, 3], fail_window=fail_window)
    return got, want


def _results_match(got, want, *, exact):
    for a, b in zip(got, want):
        da, db = a.to_dict(), b.to_dict()
        assert da.pop("backend") == "torch" and db.pop("backend") == "numpy"
        for k, v in db.items():
            if isinstance(v, float) and not exact:
                assert da[k] == pytest.approx(v, rel=REL, abs=0.0), k
            else:
                assert da[k] == v, k
        if exact:
            assert np.array_equal(a.util_timeline, b.util_timeline)


@pytest.mark.parametrize("fail_window", [None, 0, 1, 31, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_degraded_open_arm_equals_reference_bit_for_bit(name, dims, rate, fail_window):
    got, want = _degraded(name, dims, rate, seed=1, fail_window=fail_window)
    _results_match(got, want, exact=True)


@pytest.mark.parametrize("depth", [0.5, 2.0, 8.0])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_degraded_credit_arm_within_the_gate(name, dims, rate, depth):
    got, want = _degraded(name, dims, rate, seed=2, flow_control="credit", depth=depth)
    _results_match(got, want, exact=False)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 5_000), rate=st.sampled_from([0.05, 0.1, 0.2]),
       topo=st.sampled_from(TOPOLOGIES), fail_window=st.integers(0, 32))
def test_degraded_credit_at_infinite_depth_is_degraded_open(seed, rate, topo, fail_window):
    name, dims = topo
    pairs = [_pair(name, dims, seed=seed + k) for k in range(2)]
    ts, ps = [list(x) for x in zip(*[p[0] for p in pairs])]
    fs = faults.sample_link_faults(core.topology_by_name(name, *dims), rate, seed=seed, derate_frac=0.2)
    kw = dict(backend="torch", device="cpu", fail_window=fail_window)
    op = faults.degraded_batch(ts, ps, [fs, fs], noc_params=nocsim.NocSimParams(), **kw)
    cr = faults.degraded_batch(ts, ps, [fs, fs], noc_params=nocsim.NocSimParams(flow_control="credit"), **kw)
    for a, b in zip(op, cr):
        assert a.t_network_contended_s == b.t_network_contended_s
        assert a.t_drain_s == b.t_drain_s and a.mean_queue_delay_s == b.mean_queue_delay_s


@pytest.mark.parametrize("flow_control,depth", [("open", float("inf")), ("credit", 1.0), ("credit", float("inf"))])
@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_empty_faultset_reproduces_contended_batch(name, dims, flow_control, depth):
    (t, p), _ = _pair(name, dims, seed=8)
    params = nocsim.NocSimParams(flow_control=flow_control, buffer_depth=depth)
    for backend in ("torch", "numpy"):
        deg = faults.degraded_batch([t], [p], [faults.FaultSet()], noc_params=params, backend=backend,
                                    device="cpu")[0]
        ref = nocsim.contended_batch([t], [p], noc_params=params, backend=backend, device="cpu")[0]
        assert deg.to_dict() == ref.to_dict()
        assert np.array_equal(deg.util_timeline, ref.util_timeline)


def test_degraded_arm_refuses_what_the_reference_refuses():
    (t, p), _ = _pair("mesh2d", (4, 4), seed=0)
    with pytest.raises(ValueError, match="dimension-ordered"):
        faults.build_degraded_schedule(t, p, faults.FaultSet(), noc_params=nocsim.NocSimParams(routing="adaptive2"))
    s1 = faults.build_degraded_schedule(t, p, faults.FaultSet(), fail_window=3)
    s2 = faults.build_degraded_schedule(t, p, faults.FaultSet(), fail_window=5)
    with pytest.raises(ValueError, match="one fail_window"):
        faults.degraded_batch([t, t], [p, p], [faults.FaultSet()] * 2, schedules=[s1, s2], device="cpu")
