"""`repro_torch.experiments.batched` (float64 torch backend on the CPU)
against `repro`'s numpy backend and the serial simulator, all four
topologies.  Bytes are integer-valued, distances integers and the routing
operator 0/1, all below 2**53, so float64 sums re-associate exactly: total
bytes, byte-hops and the peak link load must be equal, not close."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from _hypothesis_compat import given, settings, st
from repro.core.placement import random_placement as jax_random_placement
from repro.experiments.batched import batched_weighted_hops as jax_batched_weighted_hops
from repro.experiments.batched import simulate_batch as jax_simulate_batch
from repro_torch.core.placement import random_placement
from repro_torch.experiments.batched import (
    batched_weighted_hops,
    routing_operator,
    simulate_batch,
    simulate_serial,
)
from repro_torch.graph.generators import rmat

TOPOLOGIES = [("mesh2d", (4, 5)), ("fbutterfly", (4, 4)), ("torus2d", (4, 4)), ("torus3d", (2, 3, 3))]
EXACT = ("total_bytes", "byte_hops", "t_serialization_s")  # t_serialization = peak link load / bandwidth
REL = 1e-12


def _configs(mod, rand_place, name, dims, n_graphs=3, parts=4, sparse=False):
    traffics, placements = [], []
    topo = mod.topology_by_name(name, *dims)
    for i in range(n_graphs):
        g = rmat(300, 2500, seed=i)
        act = np.random.default_rng(i).integers(0, 4, g.num_edges).astype(np.float64)
        for partitioner in ("powerlaw", "random"):
            p = mod.partition_by_name(partitioner, g.src, g.dst, g.num_nodes, parts)
            t = mod.traffic_from_partition(p, g.src, g.dst, edge_activity=act)
            traffics.append(t.to_sparse() if sparse else t)
            placements.append(rand_place(4 * parts, topo, seed=i))
    return traffics, placements


def _assert_results_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in EXACT:
            assert da[k] == db[k], k
        for k, v in db.items():
            if v is None:
                assert da[k] is None
            else:
                assert abs(da[k] - v) <= REL * max(abs(v), 1e-300), k


@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_torch_backend_equals_jax_packages_numpy_backend(name, dims):
    ta, pa = _configs(core, random_placement, name, dims)
    tb, pb = _configs(jcore, jax_random_placement, name, dims)
    iters = np.arange(1, len(ta) + 1)
    got = simulate_batch(ta, pa, num_iterations=iters, backend="torch", device="cpu")
    want = jax_simulate_batch(tb, pb, num_iterations=iters, backend="numpy")
    _assert_results_match(got, want)


@pytest.mark.parametrize("name,dims", TOPOLOGIES)
def test_torch_backend_equals_serial_simulate_per_config(name, dims):
    ta, pa = _configs(core, random_placement, name, dims)
    got = simulate_batch(ta, pa, num_iterations=5, backend="torch", device="cpu")
    want = [jcore.simulate(t, p, num_iterations=5) for t, p in zip(*_configs(jcore, jax_random_placement, name, dims))]
    _assert_results_match(got, want)
    _assert_results_match(got, simulate_serial(ta, pa, num_iterations=5))


@pytest.mark.parametrize("name,dims", TOPOLOGIES[:2])
def test_sparse_traffic_and_blocked_numpy_agree_with_torch(name, dims):
    ta, pa = _configs(core, random_placement, name, dims)
    ts, _ = _configs(core, random_placement, name, dims, sparse=True)
    dense = simulate_batch(ta, pa, backend="torch", device="cpu")
    _assert_results_match(simulate_batch(ts, pa, backend="torch", device="cpu"), dense)
    _assert_results_match(simulate_batch(ta, pa, backend="numpy"), dense)
    _assert_results_match(simulate_batch(ta, pa, pair_block=37), dense)  # forces numpy


def test_mixed_topologies_group_and_keep_input_order():
    ta, pa, tb, pb = [], [], [], []
    for name, dims in TOPOLOGIES:
        t, p = _configs(core, random_placement, name, dims, n_graphs=1)
        ta, pa = ta + t, pa + p
        t, p = _configs(jcore, jax_random_placement, name, dims, n_graphs=1)
        tb, pb = tb + t, pb + p
    _assert_results_match(
        simulate_batch(ta, pa, backend="auto", device="cpu"),
        jax_simulate_batch(tb, pb, backend="numpy"),
    )


def test_routing_operator_reaches_torch_as_sparse_csr():
    from repro_torch.experiments.batched import _torch_routing

    topo = core.Mesh2D(4, 4)
    op = _torch_routing(routing_operator(topo), torch.device("cpu"))
    assert op.layout == torch.sparse_csr and op.dtype == torch.float64
    assert _torch_routing(routing_operator(topo), torch.device("cpu")) is op  # cached per topology and device
    np.testing.assert_array_equal(op.to_dense().numpy(), routing_operator(topo).toarray())


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), c=st.integers(1, 5))
def test_batched_weighted_hops_property(seed, c):
    rng = np.random.default_rng(seed)
    topo, jtopo = core.Mesh2D(4, 4), jcore.Mesh2D(4, 4)
    w = rng.integers(0, 1000, (c, 12, 12)).astype(np.float64)
    sites = np.stack([rng.permutation(16)[:12] for _ in range(c)])
    got = batched_weighted_hops(w, sites, topo, backend="torch", device="cpu")
    np.testing.assert_array_equal(got, jax_batched_weighted_hops(w, sites, jtopo, backend="numpy"))
    np.testing.assert_array_equal(got, batched_weighted_hops(w, sites, topo, backend="numpy"))


def test_backend_and_device_rules():
    ta, pa = _configs(core, random_placement, "mesh2d", (4, 4), n_graphs=1)
    with pytest.raises(ValueError, match="unknown backend"):
        simulate_batch(ta, pa, backend="jax", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            simulate_batch(ta, pa, backend="torch")  # device=None means the card
    assert len(simulate_batch(ta, pa, backend="numpy")) == len(ta)  # numpy needs no device
