"""The float64 numpy modules of `repro_torch.core` and `repro_torch.nocsim.routes`
against `repro.core` / `repro.nocsim.routes`: equal arrays, equal scalars, and
the frozen paper-grid records through the port."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.core as jcore
import repro.core.degree as jdegree
import repro.core.placement as jplacement
import repro_torch.core as core
import repro_torch.core.degree as degree
import repro_torch.core.placement as placement
from repro.nocsim.routes import assign_adaptive2 as jax_assign_adaptive2
from repro.nocsim.routes import route_operators as jax_route_operators
from repro_torch.experiments.grid import GRIDS
from repro_torch.experiments.sweep import run_sweep
from repro_torch.graph.generators import rmat
from repro_torch.nocsim.routes import assign_adaptive2, route_operators

TOPOLOGIES = [("mesh2d", (4, 4)), ("fbutterfly", (4, 4)), ("torus2d", (4, 4)), ("torus3d", (2, 2, 4))]
PARTITIONERS = ["powerlaw", "random", "range", "hash"]


@pytest.fixture(scope="module")
def graph():
    return rmat(400, 4000, seed=5)


def _traffic(mod, g, partitioner="powerlaw", parts=4, **kw):
    p = mod.partition_by_name(partitioner, g.src, g.dst, g.num_nodes, parts)
    return p, mod.traffic_from_partition(p, g.src, g.dst, **kw)


@pytest.mark.parametrize("partitioner", PARTITIONERS)
def test_partitions_equal(graph, partitioner):
    a = core.partition_by_name(partitioner, graph.src, graph.dst, graph.num_nodes, 8)
    b = jcore.partition_by_name(partitioner, graph.src, graph.dst, graph.num_nodes, 8)
    for f in ("vertex_part", "edge_part", "rank", "order"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.name == b.name and a.edge_balance() == b.edge_balance()


@pytest.mark.parametrize("model", ["paper", "cross"])
@pytest.mark.parametrize("partitioner", ["powerlaw", "random"])
def test_traffic_dense_and_coo_equal(graph, partitioner, model):
    act = np.random.default_rng(0).integers(0, 5, graph.num_edges).astype(np.float64)
    (_, a), (_, b) = (
        _traffic(m, graph, partitioner, 4, edge_activity=act, model=model) for m in (core, jcore)
    )
    np.testing.assert_array_equal(a.bytes_matrix, b.bytes_matrix)
    assert a.phase_bytes == b.phase_bytes
    sa, sb = a.to_sparse(), b.to_sparse()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    (pa, ta), (pb, tb) = (
        (p, m.traffic_from_partition(p, graph.src, graph.dst, edge_activity=act, model=model,
                                     layout="sparse", edge_block=777))
        for m in (core, jcore)
        for p in [m.partition_by_name(partitioner, graph.src, graph.dst, graph.num_nodes, 4)]
    )
    np.testing.assert_array_equal(ta.vals, tb.vals)
    np.testing.assert_array_equal(ta.to_dense().bytes_matrix, a.bytes_matrix)


@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_topologies_distances_and_routes_equal(name, dims):
    a, b = core.topology_by_name(name, *dims), jcore.topology_by_name(name, *dims)
    np.testing.assert_array_equal(a.distance_matrix(), b.distance_matrix())
    assert a.num_links() == b.num_links()
    np.testing.assert_array_equal(a.coords(), b.coords())
    ca = [tuple(int(v) for v in c) for c in a.coords()]
    for s in range(0, a.num_nodes, 3):
        for t in range(a.num_nodes):
            assert a.route_links(ca[s], ca[t]) == b.route_links(ca[s], ca[t])
    oa, ob = route_operators(a), jax_route_operators(b)
    assert oa.link_keys == ob.link_keys
    np.testing.assert_array_equal(oa.nat.toarray(), ob.nat.toarray())
    np.testing.assert_array_equal(oa.rev.toarray(), ob.rev.toarray())
    flows = np.random.default_rng(1).integers(0, 9, (a.num_nodes, a.num_nodes)).astype(np.float64)
    np.testing.assert_array_equal(
        assign_adaptive2(oa, flows.reshape(-1)), jax_assign_adaptive2(ob, flows.reshape(-1))
    )


@pytest.mark.parametrize("method", ["random", "columnar", "quad", "greedy", "auto"])
@pytest.mark.parametrize("topo", ["mesh2d", "fbutterfly"])
def test_placement_methods_equal(graph, method, topo):
    (pa, ta), (pb, tb) = _traffic(core, graph, parts=16), _traffic(jcore, graph, parts=16)
    a = placement.place(ta, pa, placement.auto_mesh_for_parts(16, topo), method=method, seed=3)
    b = jplacement.place(tb, pb, jplacement.auto_mesh_for_parts(16, topo), method=method, seed=3)
    np.testing.assert_array_equal(a.site, b.site)
    assert a.method == b.method
    assert a.weighted_hops(ta.bytes_matrix) == b.weighted_hops(tb.bytes_matrix)


@pytest.mark.parametrize("method", ["torus_quad", "torus_columnar", "auto"])
def test_torus_placements_equal(graph, method):
    (pa, ta), (pb, tb) = _traffic(core, graph, parts=16), _traffic(jcore, graph, parts=16)
    a = placement.place(ta, pa, core.Torus2D(8, 8), method=method)
    b = jplacement.place(tb, pb, jcore.Torus2D(8, 8), method=method)
    np.testing.assert_array_equal(a.site, b.site)


def test_search_kernels_equal(graph):
    (_, ta), (_, tb) = _traffic(core, graph, parts=4), _traffic(jcore, graph, parts=4)
    topo_a, topo_b = core.Mesh2D(4, 5), jcore.Mesh2D(4, 5)
    init_a = placement.random_placement(16, topo_a, seed=1)
    init_b = jplacement.random_placement(16, topo_b, seed=1)
    np.testing.assert_array_equal(init_a.site, init_b.site)
    a = placement.two_opt_best_move(init_a, ta.bytes_matrix)
    b = jplacement.two_opt_best_move(init_b, tb.bytes_matrix)
    np.testing.assert_array_equal(a.site, b.site)
    a2 = placement.two_opt(init_a, ta.bytes_matrix, iters=300, seed=2)
    b2 = jplacement.two_opt(init_b, tb.bytes_matrix, iters=300, seed=2)
    np.testing.assert_array_equal(a2.site, b2.site)
    np.testing.assert_array_equal(
        placement.ilp_placement(ta.bytes_matrix[:6, :6], core.Mesh2D(2, 3)).site,
        jplacement.ilp_placement(tb.bytes_matrix[:6, :6], jcore.Mesh2D(2, 3)).site,
    )


@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_simulate_scalars_equal(graph, name, dims):
    (pa, ta), (pb, tb) = _traffic(core, graph, parts=4), _traffic(jcore, graph, parts=4)
    a = core.simulate(ta, placement.random_placement(16, core.topology_by_name(name, *dims), seed=2), num_iterations=7)
    b = jcore.simulate(tb, jplacement.random_placement(16, jcore.topology_by_name(name, *dims), seed=2), num_iterations=7)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_degree_and_replication_equal(graph):
    a, b = degree.skew_stats(degree.out_degrees(graph.src, graph.num_nodes)), jdegree.skew_stats(
        jdegree.out_degrees(graph.src, graph.num_nodes))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    np.testing.assert_array_equal(degree.hub_set(degree.in_degrees(graph.dst, graph.num_nodes)),
                                  jdegree.hub_set(jdegree.in_degrees(graph.dst, graph.num_nodes)))
    pa, _ = _traffic(core, graph, parts=8)
    pb, _ = _traffic(jcore, graph, parts=8)
    ra, rb = core.plan_replication(pa, graph.src, graph.dst), jcore.plan_replication(pb, graph.src, graph.dst)
    for f in dataclasses.fields(ra):
        x, y = getattr(ra, f.name), getattr(rb, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_device_mapper_equal(graph):
    a = core.DeviceMapper((4, 4)).device_permutation(graph.src, graph.dst, graph.num_nodes)
    b = jcore.DeviceMapper((4, 4)).device_permutation(graph.src, graph.dst, graph.num_nodes)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2:] == b[2:]


# ---- the frozen paper-grid records (amazon slice, scale 0.01) through the port -------------

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_paper_amazon.json"
SKIP_FIELDS = {"elapsed_us"}  # wall clock


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_port_reproduces_golden_paper_amazon(backend):
    """BFS/SSSP traces are exact and the PageRank trace hits the 40-sweep cap
    in both engines, so the whole integer-domain pipeline reproduces the
    frozen records bit for bit, on either backend, with the ELL-summed
    PageRank of the port."""
    golden = json.loads(FIXTURE.read_text())["records"]
    grid = dataclasses.replace(GRIDS["paper"], workloads=("amazon",))
    res = run_sweep(grid, cache_dir=None, backend=backend, device="cpu", measure_serial=False)
    got = {r["key"]: r for r in res.to_dict()["records"]}
    assert len(golden) == 12 and res.backend == backend
    for ref in golden:
        rec = got[ref["key"]]
        for field, want in ref.items():
            if field not in SKIP_FIELDS:
                assert rec[field] == want, f"{ref['key']}.{field}: {rec[field]!r} vs golden {want!r}"
