"""The slice as a whole: `repro_torch`'s `run_sweep` and `map_graph` on the CPU
against `repro`'s numpy-backend sweep, record for record; the `interop`
constructors; the parts that wait for a later slice refuse by name."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from repro.experiments import GRIDS as JAX_GRIDS
from repro.experiments import run_sweep as jax_run_sweep
from repro.graph.generators import rmat as jax_rmat
from repro.graph.structs import build_ell as jax_build_ell
from repro.graph.vertex_program import run_traced as jax_run_traced
from repro.graph import algorithms as jalg
from repro_torch import interop
from repro_torch.experiments import GRIDS, SweepCache, figure_comparisons, run_sweep
from repro_torch.experiments.cache import DEFAULT_CACHE_DIR
from repro_torch.graph import algorithms as alg
from repro_torch.graph.generators import rmat
from repro_torch.graph.vertex_program import run_traced
from repro_torch.kernels.segment_spmm.ops import segment_spmm

REL = 1e-9


def _assert_records_match(got, want):
    assert [r.config.key for r in got] == [r.config.key for r in want]
    for a, b in zip(got, want):
        assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
        assert (a.num_nodes, a.num_edges, a.num_iterations) == (b.num_nodes, b.num_edges, b.num_iterations)
        assert a.placement_method == b.placement_method
        assert a.edge_balance == b.edge_balance and a.phase_norm == b.phase_norm
        for k, v in dataclasses.asdict(b.result).items():
            u = getattr(a.result, k)
            if v is None:
                assert u is None
            else:
                assert abs(u - v) <= REL * max(abs(v), 1e-300), (a.config.key, k)


@pytest.fixture(scope="module")
def mini_pair(tmp_path_factory):
    cache_dir = tmp_path_factory.mktemp("torch_cache")
    port = run_sweep(GRIDS["mini"], backend="torch", device="cpu", cache_dir=str(cache_dir),
                     keep_artifacts=True)
    ref = jax_run_sweep(JAX_GRIDS["mini"], backend="numpy")
    return port, ref, cache_dir


def test_mini_sweep_matches_jax_package_record_for_record(mini_pair):
    port, ref, _ = mini_pair
    assert port.backend == "torch" and ref.backend == "numpy"
    _assert_records_match(port.records, ref.records)
    comps, jcomps = figure_comparisons(port.records), ref.to_dict()["comparisons"]
    assert len(comps) == len(jcomps) > 0
    for a, b in zip(comps, jcomps):
        assert a["speedup"] > 1.0
        assert abs(a["speedup"] - b["speedup"]) <= REL * b["speedup"]
    assert port.placement_stats["backend"] == "torch"
    assert port.placement_stats["greedy_constructed"] == ref.placement_stats["greedy_constructed"] == 1
    assert port.contention is None and port.to_dict()["contention"] is None


def test_mini_sweep_placements_equal_the_jax_packages(mini_pair):
    port, _, _ = mini_pair
    art = port.artifacts
    assert set(art) == {"traffics", "partitions", "topologies", "placements", "num_iterations"}
    configs = JAX_GRIDS["mini"].expand()
    from repro.experiments.cache import SweepCache as JaxCache
    from repro.core.placement import auto_mesh_for_parts
    from repro.experiments.placement_batch import place_batch as jax_place_batch
    from repro.graph.generators import table2_workloads

    g = table2_workloads(scale=configs[0].scale, seed=0, names=("amazon",))["amazon"]
    cache = JaxCache(None)
    trace = cache.trace(g, "bfs", max_iterations=200)
    parts = [cache.partition(g, c.partitioner, c.num_parts) for c in configs]
    traffics = [cache.traffic(g, p, trace) for p in parts]
    topos = [auto_mesh_for_parts(c.num_parts, c.topology) for c in configs]
    want, _ = jax_place_batch(traffics, parts, topos, methods=[c.placement for c in configs],
                              seeds=[c.seed for c in configs], backend="numpy")
    for t_port, t_ref in zip(art["traffics"], traffics):
        np.testing.assert_array_equal(t_port.bytes_matrix, t_ref.bytes_matrix)
    for a, b in zip(art["placements"], want):
        np.testing.assert_array_equal(a.site, b.site)


def test_cache_is_the_ports_own_and_hits_on_a_second_run(mini_pair):
    port, _, cache_dir = mini_pair
    assert port.cache_stats["trace_misses"] == 1 and port.cache_stats["trace_hits"] == 0
    again = run_sweep(GRIDS["mini"], backend="torch", device="cpu", cache_dir=str(cache_dir),
                      measure_serial=False)
    assert again.cache_stats["trace_hits"] == 1 and again.cache_stats["trace_misses"] == 0
    _assert_records_match(again.records, port.records)
    assert DEFAULT_CACHE_DIR.replace("\\", "/") == "artifacts/torch/sweep_cache"
    # the trace key names the engine, so the same graph keys differently in the two packages
    from repro.experiments.cache import SweepCache as JaxCache

    g = rmat(64, 256, seed=0)
    a, b = SweepCache(str(cache_dir), device="cpu"), JaxCache(str(cache_dir))
    before = set(p.name for p in cache_dir.iterdir())
    a.trace(g, "bfs")
    mine = set(p.name for p in cache_dir.iterdir()) - before
    b.trace(jax_rmat(64, 256, seed=0), "bfs")
    theirs = set(p.name for p in cache_dir.iterdir()) - before - mine
    assert len(mine) == 1 and len(theirs) == 1 and b.stats.trace_hits == 0


@pytest.mark.parametrize("backend", ["numpy", "auto"])
def test_other_backends_give_the_same_records(mini_pair, backend):
    port, _, _ = mini_pair
    res = run_sweep(GRIDS["mini"], backend=backend, device="cpu", measure_serial=False)
    assert res.backend == ("torch" if backend == "auto" else "numpy")
    _assert_records_match(res.records, port.records)


def test_pagerank_sweep_matches_with_either_reduce(tmp_path):
    grid = dataclasses.replace(GRIDS["mini"], algorithms=("pagerank", "sssp"))
    jgrid = dataclasses.replace(JAX_GRIDS["mini"], algorithms=("pagerank", "sssp"))
    ref = jax_run_sweep(jgrid, backend="numpy", measure_serial=False)
    for impl in ("scatter", "ell"):
        port = run_sweep(grid, backend="torch", device="cpu", reduce_impl=impl, measure_serial=False)
        _assert_records_match(port.records, ref.records)


def test_later_slices_are_refused_by_name():
    for grid in (GRIDS["contention"], dataclasses.replace(GRIDS["mini"], fault_rates=(0.0, 0.05))):
        with pytest.raises(NotImplementedError, match="later slice"):
            run_sweep(grid, device="cpu")
    with pytest.raises(NotImplementedError, match="flight recorder"):
        run_sweep(GRIDS["mini"], device="cpu", recorder=object())


def test_run_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(GRIDS["mini"])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(partitioner="random", placement_method="random"),
    dict(placement_method="greedy", traffic_model="cross"),
    dict(with_replication=True),
])
def test_map_graph_matches(kw):
    g = rmat(500, 5000, seed=2)
    act = np.random.default_rng(0).integers(0, 3, g.num_edges).astype(np.float64)
    a = core.map_graph(g.src, g.dst, g.num_nodes, 16, edge_activity=act, **kw)
    b = jcore.map_graph(g.src, g.dst, g.num_nodes, 16, edge_activity=act, **kw)
    np.testing.assert_array_equal(a.partition.vertex_part, b.partition.vertex_part)
    np.testing.assert_array_equal(a.traffic.bytes_matrix, b.traffic.bytes_matrix)
    np.testing.assert_array_equal(a.placement.site, b.placement.site)
    assert (a.replication is None) == (b.replication is None)
    assert dataclasses.asdict(a.simulate(num_iterations=3)) == dataclasses.asdict(b.simulate(num_iterations=3))


# ---- interop: the JAX package's state, as numpy arrays and plain values, into the port -----


def test_interop_graph_and_ell_round_trip():
    jg = jalg.pagerank_edge_weights(jax_rmat(150, 900, seed=1))
    g = interop.host_graph(jg.num_nodes, jg.src, jg.dst, jg.weight, jg.name)
    assert g.num_edges == jg.num_edges and g.name == jg.name
    jell = jax_build_ell(jg.reversed())
    ell = interop.ell_blocks(
        jell.num_nodes, [np.asarray(r) for r in jell.rows], [np.asarray(c) for c in jell.cols],
        [np.asarray(w) for w in jell.weights], jell.widths, device="cpu",
    )
    assert ell.widths == jell.widths and ell.fill_fraction() == pytest.approx(jell.fill_fraction())
    x = np.random.default_rng(0).standard_normal((150, 8)).astype(np.float32)
    from repro.kernels.segment_spmm.ops import segment_spmm as jax_segment_spmm
    import jax.numpy as jnp

    np.testing.assert_allclose(
        segment_spmm(torch.from_numpy(x), ell).numpy(),
        np.asarray(jax_segment_spmm(jnp.asarray(x), jell, impl="ref")), rtol=2e-3, atol=2e-5,
    )


def test_interop_trace_partition_traffic_placement_round_trip():
    jg = jax_rmat(300, 2400, seed=7)
    jtr = jax_run_traced(jg, jalg.bfs_program())
    tr = interop.trace_result(**dataclasses.asdict(jtr))
    g = interop.host_graph(jg.num_nodes, jg.src, jg.dst, jg.weight)
    mine = run_traced(g, alg.bfs_program(), device="cpu")
    np.testing.assert_array_equal(tr.edge_activity, mine.edge_activity)
    assert tr.frontier_sizes == mine.frontier_sizes and tr.num_iterations == mine.num_iterations

    jp = jcore.powerlaw_partition(jg.src, jg.dst, jg.num_nodes, 4)
    p = interop.partition(**dataclasses.asdict(jp))
    jt = jcore.traffic_from_partition(jp, jg.src, jg.dst, edge_activity=jtr.edge_activity)
    t = interop.traffic_matrix(**dataclasses.asdict(jt))
    np.testing.assert_array_equal(
        core.traffic_from_partition(p, g.src, g.dst, edge_activity=tr.edge_activity).bytes_matrix, t.bytes_matrix
    )
    jpl = jcore.place(jt, jp, jcore.Mesh2D(4, 4), method="greedy")
    pl = interop.placement("mesh2d", (4, 4), jpl.site, jpl.method)
    assert pl.method == jpl.method and pl.weighted_hops(t.bytes_matrix) == jpl.weighted_hops(jt.bytes_matrix)
    assert dataclasses.asdict(core.simulate(t, pl)) == dataclasses.asdict(jcore.simulate(jt, jpl))
