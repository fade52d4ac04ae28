"""`repro_torch.experiments.placement_batch` torch backends (CPU) against the
JAX package's float64 numpy backends, on integer-byte weights, where float64
sums re-associate exactly: equal sites, equal step counts, equal deltas."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from _hypothesis_compat import given, settings, st
from repro.core.placement import place as jax_place
from repro.experiments import placement_batch as jpb
from repro_torch.core.placement import swap_candidates_topk
from repro_torch.experiments import placement_batch as pb
from repro_torch.graph.generators import rmat

CPU = dict(backend="torch", device="cpu")


def _paper_configs(mod, n_graphs=3, parts=16, torus=False):
    """Paper-grid-shaped configs: real integer-byte traffic on 8×8 fabrics."""
    traffics, partitions, topologies = [], [], []
    for i in range(n_graphs):
        g = rmat(400, 4000, seed=i)
        for partitioner in ("powerlaw", "random"):
            p = mod.partition_by_name(partitioner, g.src, g.dst, g.num_nodes, parts)
            traffics.append(mod.traffic_from_partition(p, g.src, g.dst))
            partitions.append(p)
            if torus:
                topologies.append(mod.Torus2D(8, 8))
            else:
                topologies.append(mod.Mesh2D(8, 8) if i % 2 == 0 else mod.FlattenedButterfly(8, 8))
    return traffics, partitions, topologies


def _integer_weight_stack(seed, n, c, density=0.4):
    """Integer-valued weights with some zero-connectivity shards, which send
    the greedy constructor to its seeded random fallback."""
    rng = np.random.default_rng(seed)
    ws = []
    for _ in range(c):
        w = rng.integers(1, 10_000, (n, n)).astype(np.float64) * (rng.random((n, n)) < density)
        np.fill_diagonal(w, 0.0)
        for i in rng.integers(n, size=rng.integers(0, 3)):
            w[:, i] = 0.0
            w[i, :] = 0.0
        ws.append(w)
    return ws


def _topos(mod, c):
    kinds = [mod.Mesh2D(4, 6), mod.Torus2D(4, 6), mod.FlattenedButterfly(4, 6)]
    return [kinds[k % 3] for k in range(c)]


def test_greedy_construct_equals_numpy_on_real_traffic():
    ta, _, topa = _paper_configs(core)
    tb, _, topb = _paper_configs(jcore)
    seeds = list(range(len(ta)))
    got, backend = pb.greedy_construct_batch([t.bytes_matrix for t in ta], topa, seeds=seeds, **CPU)
    want, _ = jpb.greedy_construct_batch([t.bytes_matrix for t in tb], topb, seeds=seeds, backend="numpy")
    assert backend == "torch"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_greedy_rng_fallback_draws_the_numpy_streams(seed):
    ws = _integer_weight_stack(seed, n=20, c=6, density=0.2)
    got, _ = pb.greedy_construct_batch(ws, _topos(core, 6), seeds=7, **CPU)
    want, _ = jpb.greedy_construct_batch(ws, _topos(jcore, 6), seeds=7, backend="numpy")
    for a, b, w, topo in zip(got, want, ws, _topos(jcore, 6)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, jcore.greedy_placement(w, topo, seed=7).site)


@pytest.mark.parametrize("method", ["torus_quad", "torus_columnar"])
def test_torus_construct_equals_numpy(method):
    ta, _, topa = _paper_configs(core, torus=True)
    tb, _, topb = _paper_configs(jcore, torus=True)
    got, backend = pb.torus_construct_batch([t.bytes_matrix for t in ta], topa, methods=method, **CPU)
    want, _ = jpb.torus_construct_batch([t.bytes_matrix for t in tb], topb, methods=method, backend="numpy")
    assert backend == "torch"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _descent_inputs(mod, seed, c=5, n=16):
    rng = np.random.default_rng(seed)
    ws = _integer_weight_stack(seed, n=n, c=c, density=0.6)
    topos = _topos(mod, c)
    inits = [rng.permutation(24)[:n] for _ in range(c)]
    return ws, topos, inits


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_descend_equals_numpy_sites_and_steps(seed):
    ws, topa, inits = _descent_inputs(core, seed)
    _, topb, _ = _descent_inputs(jcore, seed)
    got, gs = pb.batch_descend(ws, topa, inits, **CPU)
    want, ws_ = jpb.batch_descend(ws, topb, inits, backend="numpy")
    assert gs.steps == ws_.steps and gs.backend == "torch"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a step budget that cuts the descent short stops both at the same layout
    got2, gs2 = pb.batch_descend(ws, topa, inits, max_steps=3, **CPU)
    want2, ws2 = jpb.batch_descend(ws, topb, inits, max_steps=3, backend="numpy")
    assert gs2.steps == ws2.steps == 3
    for a, b in zip(got2, want2):
        np.testing.assert_array_equal(a, b)


def test_batch_descend_on_paper_traffic_equals_numpy_and_serial():
    ta, _, topa = _paper_configs(core, n_graphs=2)
    tb, _, topb = _paper_configs(jcore, n_graphs=2)
    inits = [core.quad_placement(16, t).site for t in topa]
    got, gs = pb.batch_descend([t.bytes_matrix for t in ta], topa, inits, **CPU)
    want, ws = jpb.batch_descend([t.bytes_matrix for t in tb], topb, inits, backend="numpy")
    assert gs.steps == ws.steps
    for a, b, t, topo, init in zip(got, want, tb, topb, inits):
        np.testing.assert_array_equal(a, b)
        serial = jcore.placement.two_opt_best_move(jcore.Placement(topo, init, "quad"), t.bytes_matrix)
        np.testing.assert_array_equal(a, serial.site)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_batch_equals_numpy_sites_and_steps(seed):
    ws, topa, inits = _descent_inputs(core, seed, c=4, n=14)
    dists = [t.distance_matrix().astype(np.float64) for t in topa]
    rng = np.random.default_rng(seed)
    blocked = []
    for init in inits:
        b = np.zeros(24, dtype=bool)
        free = np.setdiff1d(np.arange(24), init)
        b[rng.choice(free, size=3, replace=False)] = True  # dead routers nobody sits on
        blocked.append(b)
    got, gs = pb.repair_batch(ws, dists, inits, blocked, max_steps=6, **CPU)
    want, ws_ = jpb.repair_batch(ws, dists, inits, blocked, max_steps=6, backend="numpy")
    assert gs.steps == ws_.steps
    for a, b, blk in zip(got, want, blocked):
        np.testing.assert_array_equal(a, b)
        assert not blk[a].any()
    same, s0 = pb.repair_batch(ws, dists, inits, blocked, max_steps=0, **CPU)
    assert s0.steps == 0 and all(np.array_equal(a, b) for a, b in zip(same, inits))


def test_sparse_weighted_hops_batch_equals_numpy():
    ta, _, topa = _paper_configs(core)
    tb, _, topb = _paper_configs(jcore)
    sites = [np.random.default_rng(i).permutation(64) for i in range(len(ta))]
    coos_a = [(s.rows, s.cols, s.vals) for s in (t.to_sparse() for t in ta)]
    coos_b = [(s.rows, s.cols, s.vals) for s in (t.to_sparse() for t in tb)]
    got, backend = pb.sparse_weighted_hops_batch(coos_a, sites, topa, **CPU)
    want, _ = jpb.sparse_weighted_hops_batch(coos_b, sites, topb, backend="numpy")
    assert backend == "torch"
    np.testing.assert_array_equal(got, want)


def test_swap_delta_pairs_batch_equals_numpy():
    ta, _, topa = _paper_configs(core, n_graphs=2)
    tb, _, topb = _paper_configs(jcore, n_graphs=2)
    sites = [np.random.default_rng(i).permutation(64) for i in range(len(ta))]
    ws = [t.bytes_matrix for t in ta]
    pairs = [
        swap_candidates_topk(s.rows, s.cols, s.vals, 64, k=3 + i)
        for i, s in enumerate(t.to_sparse() for t in ta)
    ]
    got, backend = pb.swap_delta_pairs_batch(ws, topa, sites, pairs, **CPU)
    want, _ = jpb.swap_delta_pairs_batch([t.bytes_matrix for t in tb], topb, sites, pairs, backend="numpy")
    assert backend == "torch"
    for a, b, p in zip(got, want, pairs):
        assert a.shape == p[0].shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("methods", ["auto", "greedy"])
def test_place_batch_equals_numpy_and_is_no_worse_than_serial(methods):
    ta, pa, topa = _paper_configs(core)
    tb, pbs, topb = _paper_configs(jcore)
    got, gs = pb.place_batch(ta, pa, topa, methods=methods, seeds=0, **CPU)
    want, ws = jpb.place_batch(tb, pbs, topb, methods=methods, seeds=0, backend="numpy")
    assert gs.backend == "torch" and gs.batched_configs == ws.batched_configs == len(ta)
    assert gs.steps == ws.steps and gs.greedy_constructed == ws.greedy_constructed
    for a, b, t, p, topo in zip(got, want, tb, pbs, topb):
        np.testing.assert_array_equal(a.site, b.site)
        assert a.method == b.method and a.method.endswith(pb.BATCH_METHOD_SUFFIX)
        serial = jax_place(t, p, topo, method=methods, seed=0)
        assert a.weighted_hops(t.bytes_matrix) <= serial.weighted_hops(t.bytes_matrix) + 1e-9


def test_place_batch_mixed_routes_and_restarts():
    ta, pa, _ = _paper_configs(core, n_graphs=2)
    tb, pbs, _ = _paper_configs(jcore, n_graphs=2)
    topa = [core.Torus2D(8, 8), core.Mesh2D(8, 8), core.Mesh2D(8, 8), core.FlattenedButterfly(8, 8)]
    topb = [jcore.Torus2D(8, 8), jcore.Mesh2D(8, 8), jcore.Mesh2D(8, 8), jcore.FlattenedButterfly(8, 8)]
    methods = ["auto", "auto", "random", "greedy"]
    got, gs = pb.place_batch(ta, pa, topa, methods=methods, seeds=[0, 1, 2, 3], restarts=1, **CPU)
    want, ws = jpb.place_batch(tb, pbs, topb, methods=methods, seeds=[0, 1, 2, 3], restarts=1, backend="numpy")
    assert (gs.torus_constructed, gs.serial_configs, gs.batched_configs) == (1, 1, 2)
    assert (ws.torus_constructed, ws.serial_configs, ws.batched_configs) == (1, 1, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.site, b.site)
        assert a.method == b.method


def test_first_minimum_tie_break_of_torch_argmin():
    """The bit-equal descent rests on a flat argmin that returns the first
    minimum, as numpy's does."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0], [0.0, 0.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    assert x.argmin(dim=1).tolist() == x.numpy().argmin(axis=1).tolist() == [1, 0]
    assert x.min(dim=1).indices.tolist() == [1, 0]
    assert (-x).max(dim=1).indices.tolist() == [1, 0]
