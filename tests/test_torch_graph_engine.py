"""`repro_torch.graph` (generators, containers, vertex engine, the three
algorithms) against `repro.graph` on the same seeded graphs, on the CPU."""
import numpy as np
import pytest
import torch

from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro.graph.structs import to_device_edges as jax_to_device_edges
from repro.graph.vertex_program import run_traced as jax_run_traced
from repro_torch.graph import algorithms as alg
from repro_torch.graph import generators as gen
from repro_torch.graph.structs import HostGraph, to_device_edges
from repro_torch.graph.vertex_program import run, run_traced

TRACE_ITERS = {"pagerank": 40}


def _port_graph(g) -> HostGraph:
    return HostGraph(g.num_nodes, g.src, g.dst, g.weight, g.name)


def _both(name, g, **kw):
    iters = TRACE_ITERS.get(name, 200)
    got = run_traced(alg.prepare_graph(name, _port_graph(g)), alg.ALGORITHMS[name](),
                     max_iterations=iters, device="cpu", **kw)
    want = jax_run_traced(jalg.prepare_graph(name, g), jalg.ALGORITHMS[name](), max_iterations=iters)
    return got, want


def _assert_trace_fields_equal(got, want):
    assert got.num_iterations == want.num_iterations
    assert got.frontier_sizes == want.frontier_sizes
    assert got.edge_activity.dtype == want.edge_activity.dtype == np.float64
    assert got.vertex_activity.dtype == want.vertex_activity.dtype == np.float64
    np.testing.assert_array_equal(got.edge_activity, want.edge_activity)
    np.testing.assert_array_equal(got.vertex_activity, want.vertex_activity)


@pytest.mark.parametrize("fixture", ["rmat_graph", "small_powerlaw"])
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_min_programs_trace_equals_jax_exactly(request, fixture, name):
    g = request.getfixturevalue(fixture)
    got, want = _both(name, g)
    _assert_trace_fields_equal(got, want)
    assert got.props.dtype == want.props.dtype == np.float32
    np.testing.assert_array_equal(got.props, want.props)


@pytest.mark.parametrize("fixture", ["rmat_graph", "small_powerlaw"])
def test_pagerank_scatter_trace_equals_jax(request, fixture):
    g = request.getfixturevalue(fixture)
    got, want = _both("pagerank", g, reduce_impl="scatter")
    _assert_trace_fields_equal(got, want)
    np.testing.assert_allclose(got.props, want.props, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fixture", ["rmat_graph", "small_powerlaw"])
def test_pagerank_scatter_props_equal_jax_bit_for_bit(request, fixture):
    """With the reference's summation order (a segment sum in edge order) and
    its one-rounding update, the ranks are the reference's bits."""
    g = request.getfixturevalue(fixture)
    got, want = _both("pagerank", g, reduce_impl="scatter")
    np.testing.assert_array_equal(got.props, want.props)


def test_fma_f32_gives_the_references_contracted_update():
    """XLA's CPU backend emits PageRank's `base + damping * temp` as one fused
    multiply-add; `fma_f32` gives its bits, where two roundings do not."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    temp = np.exp(rng.uniform(np.log(1e-9), np.log(1e2), 200_000)).astype(np.float32)
    for base in (np.float32(0.15 / 54_000), np.float32(0.15 / 3_040), np.float32(0.15)):
        want = np.asarray(jax.jit(lambda t: base + 0.85 * t)(jnp.asarray(temp)))
        got = alg.fma_f32(0.85, torch.from_numpy(temp), torch.tensor(base)).numpy()
        np.testing.assert_array_equal(got, want)
        assert ((base + np.float32(0.85) * temp) != want).any()


@pytest.mark.parametrize("fixture", ["rmat_graph", "small_powerlaw"])
def test_pagerank_ell_matches_jax_and_host_reference(request, fixture):
    """The ELL path sums each row in another order than a segment sum."""
    g = request.getfixturevalue(fixture)
    got, want = _both("pagerank", g, reduce_impl="ell")
    np.testing.assert_allclose(got.props, want.props, rtol=2e-3, atol=2e-5)
    default, _ = _both("pagerank", g)  # a declared weighted product defaults to "ell"
    np.testing.assert_array_equal(default.props, got.props)
    gp = alg.prepare_graph("pagerank", _port_graph(g))
    long_run = run(gp, alg.pagerank_program(), max_iterations=200, device="cpu").props
    np.testing.assert_allclose(long_run, alg.reference_pagerank(gp), atol=1e-4)
    np.testing.assert_allclose(long_run, jalg.reference_pagerank(jalg.prepare_graph("pagerank", g)), atol=1e-4)


@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank"])
def test_run_equals_run_traced(rmat_graph, name):
    gp = alg.prepare_graph(name, _port_graph(rmat_graph))
    a = run(gp, alg.ALGORITHMS[name](), device="cpu")
    b = run_traced(gp, alg.ALGORITHMS[name](), device="cpu", max_iterations=10_000)
    np.testing.assert_array_equal(a.props, b.props)
    assert a.num_iterations == b.num_iterations


def test_host_references_agree_with_engine(rmat_graph):
    g = _port_graph(rmat_graph)
    np.testing.assert_array_equal(run(g, alg.bfs_program(), device="cpu").props, alg.reference_bfs(g, 0))
    gw = alg.prepare_graph("sssp", g)
    np.testing.assert_allclose(run(gw, alg.sssp_program(), device="cpu").props, alg.reference_sssp(gw, 0), rtol=1e-5)
    np.testing.assert_array_equal(alg.reference_bfs(g, 0), jalg.reference_bfs(rmat_graph, 0))


def test_padded_edges_are_inert(rmat_graph):
    g = _port_graph(rmat_graph)
    a = run_traced(g, alg.bfs_program(), device="cpu")
    b = run_traced(g, alg.bfs_program(), device="cpu", pad_to=g.num_edges + 173)
    np.testing.assert_array_equal(a.props, b.props)
    np.testing.assert_array_equal(a.edge_activity, b.edge_activity)
    gp = alg.prepare_graph("pagerank", g)
    c = run_traced(gp, alg.pagerank_program(), device="cpu", max_iterations=5)
    d = run_traced(gp, alg.pagerank_program(), device="cpu", max_iterations=5, pad_to=g.num_edges + 9)
    np.testing.assert_array_equal(c.props, d.props)


def test_reduce_impl_follows_the_programs_declaration():
    assert alg.pagerank_program().default_reduce_impl() == "ell"
    assert alg.bfs_program().default_reduce_impl() == "scatter"
    g = gen.rmat(60, 300, seed=0)
    with pytest.raises(ValueError, match="weighted_product"):
        run_traced(g, alg.bfs_program(), device="cpu", reduce_impl="ell")
    with pytest.raises(ValueError, match="unknown reduce_impl"):
        run_traced(g, alg.bfs_program(), device="cpu", reduce_impl="segment")


def test_timings_out_parameter(small_powerlaw):
    t = {}
    run_traced(_port_graph(small_powerlaw), alg.bfs_program(), device="cpu", timings=t)
    assert set(t) == {"prepare_s", "loop_s"} and all(v >= 0 for v in t.values())


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.rmat(300, 2400, seed=7),
        lambda m: m.rmat(64, 512, seed=3, weighted=True),
        lambda m: m.uniform_random(80, 400, seed=1),
        lambda m: m.chung_lu(100, 600, seed=2),
        lambda m: m.grid2d(6, 5),
        lambda m: m.table2_workloads(scale=0.001, seed=4)["wiki"],
    ],
    ids=["rmat", "rmat-weighted", "uniform", "chung-lu", "grid2d", "table2"],
)
def test_generators_give_the_jax_packages_edges(make):
    a, b = make(gen), make(jgen)
    assert a.num_nodes == b.num_nodes and a.name == b.name
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    assert (a.weight is None) == (b.weight is None)
    if a.weight is not None:
        np.testing.assert_array_equal(a.weight, b.weight)


def test_device_edges_keep_the_sentinel_conventions(small_powerlaw):
    g = _port_graph(small_powerlaw)
    e = to_device_edges(g, pad_to=g.num_edges + 7, device="cpu")
    je = jax_to_device_edges(small_powerlaw, pad_to=g.num_edges + 7)
    assert e.src.dtype == torch.int32 and e.valid.dtype == torch.bool
    np.testing.assert_array_equal(e.src.numpy(), np.asarray(je.src))
    np.testing.assert_array_equal(e.dst.numpy(), np.asarray(je.dst))
    np.testing.assert_array_equal(e.valid.numpy(), np.asarray(je.valid))
    assert int(e.src[-1]) == g.num_nodes and not bool(e.valid[-1])
    with pytest.raises(ValueError):
        to_device_edges(g, pad_to=3, device="cpu")
