"""`repro_torch.graph.distributed` against `repro.graph.distributed` on the
same seeded graphs and partitions (`interop.host_graph`, `interop.partition`):

* `ShardedVertexGraph.build` bit-equal to the reference's at P ∈ {1, 4, 8}
  for the four partitioners, the capacity spill's re-homing included;
* `DistributedEngine` on one stacked engine against the reference's engine
  on its one-device mesh: BFS/SSSP bit-equal with the same iteration count,
  PageRank within the reference's own bounds against `reference_pagerank`
  (atol 1e-3; the bf16 exchange 5e-2, `tests/test_distributed.py:61-90`);
* 4 and 8 stacked engines against the port's one-device `run` (BFS/SSSP
  bit-equal; PageRank at the same iteration count within 1e-5 of the largest
  rank: float32 sums of the same messages in another order) and against the
  reference's `reference_*` functions;
* the "process_group" backend over gloo (4 spawned ranks, a permutation that
  is not the identity) bit-equal to the stacked one, iteration counts too;
* the example `examples/torch_distributed_graph_analytics.py` on the CPU:
  its hop and bytes lines equal what the reference's mapper and traffic
  model give.
"""
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_mesh_runs import PERMUTATION, WORLD, engine_runs, run_gloo
from repro.core.partition import partition_by_name as jpartition_by_name
from repro.graph import algorithms as jalg
from repro.graph.distributed import DistributedEngine as JEngine
from repro.graph.distributed import ShardedVertexGraph as JSharded
from repro.graph.distributed import make_engines_mesh as jmake_engines_mesh
from repro.graph.generators import rmat as jrmat
from repro_torch import interop
from repro_torch.graph import algorithms as alg
from repro_torch.graph.distributed import (
    DistributedEngine,
    EngineMesh,
    ShardedVertexGraph,
    fold,
    make_engines_mesh,
)
from repro_torch.graph.vertex_program import run
from repro_torch.kernels.segment_spmm.ops import segment_spmm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARTITIONERS = ("powerlaw", "random", "range", "hash")
PAGERANK_REL = 1e-5  # of the largest rank, same iteration count, float32 sums in another order
JAX_BOUNDS = {"pagerank": 1e-3, "pagerank_bf16": 5e-2}  # tests/test_distributed.py:80, :90


def _graph(jg):
    return interop.host_graph(jg.num_nodes, jg.src, jg.dst, jg.weight, jg.name)


def _part(jp):
    return interop.partition(num_parts=jp.num_parts, vertex_part=jp.vertex_part, edge_part=jp.edge_part,
                             rank=jp.rank, order=jp.order, name=jp.name)


def _assert_build_equal(jg, jp):
    want = JSharded.build(jg, jp)
    got = ShardedVertexGraph.build(_graph(jg), _part(jp))
    assert (got.num_devices, got.num_nodes, got.n_local, got.e_local) == (
        want.num_devices, want.num_nodes, want.n_local, want.e_local)
    for f in ("src_slot", "dst_key", "weight", "valid", "slot_to_vertex"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return got


@pytest.mark.parametrize("weighted", [False, True], ids=["bfs", "sssp"])
@pytest.mark.parametrize("partitioner", PARTITIONERS)
@pytest.mark.parametrize("parts", [1, 4, 8])
def test_build_is_bit_equal_to_the_reference(small_powerlaw, parts, partitioner, weighted):
    jg = jalg.prepare_graph("sssp", small_powerlaw) if weighted else small_powerlaw
    _assert_build_equal(jg, jpartition_by_name(partitioner, jg.src, jg.dst, jg.num_nodes, parts))


def test_the_spill_branch_runs_and_rehomes_every_spilled_edge(small_powerlaw):
    """The default powerlaw partition of rmat(64, 512, seed=3) at P = 4 spills
    50 edges onto parts that do not own their source; the build moves them
    back, so every edge's source is engine-local."""
    jg = small_powerlaw
    jp = jpartition_by_name("powerlaw", jg.src, jg.dst, jg.num_nodes, 4)
    assert int((jp.vertex_part[jg.src] != jp.edge_part).sum()) == 50
    sg = _assert_build_equal(jg, jp)
    assert sg.rehomed_edges == 50 and int(sg.valid.sum()) == jg.num_edges
    for e in range(4):
        vs = sg.slot_to_vertex[e, sg.src_slot[e][sg.valid[e]]]
        assert (jp.vertex_part[vs] == e).all()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), parts=st.integers(1, 9), partitioner=st.sampled_from(PARTITIONERS))
def test_build_is_bit_equal_on_random_graphs(seed, parts, partitioner):
    jg = jrmat(50 + seed % 70, 300 + seed % 500, seed=seed)
    _assert_build_equal(jg, jpartition_by_name(partitioner, jg.src, jg.dst, jg.num_nodes, parts))


def _programs(name):
    jprog = {"bfs": jalg.bfs_program, "sssp": jalg.sssp_program}.get(name, jalg.pagerank_program)()
    return jprog, alg.ALGORITHMS[name.removesuffix("_bf16")]()


@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank", "pagerank_bf16"])
@pytest.mark.parametrize("partitioner", ["powerlaw", "random"])
def test_one_stacked_engine_equals_the_reference_engine(small_powerlaw, partitioner, name):
    base = name.removesuffix("_bf16")
    jg = jalg.prepare_graph(base, small_powerlaw)
    jp = jpartition_by_name(partitioner, jg.src, jg.dst, jg.num_nodes, 1)
    bf16 = name.endswith("_bf16")
    jprog, prog = _programs(name)
    want, want_it = JEngine(jprog, jmake_engines_mesh(), comm_dtype=jnp.bfloat16 if bf16 else None).run(jg, jp)
    mesh = make_engines_mesh(device="cpu")
    got, it = DistributedEngine(prog, mesh, comm_dtype=torch.bfloat16 if bf16 else None).run(_graph(jg), _part(jp))
    if base == "pagerank":
        ref = jalg.reference_pagerank(jg)
        np.testing.assert_allclose(got, ref, atol=JAX_BOUNDS[name])
        np.testing.assert_allclose(got, want, atol=JAX_BOUNDS[name])
    else:
        assert np.array_equal(got, want) and it == want_it


@pytest.mark.parametrize("partitioner", PARTITIONERS)
@pytest.mark.parametrize("parts", [4, 8])
def test_stacked_engines_equal_one_device(parts, partitioner):
    """tests/test_multidevice_subprocess.py:40's graph, on P stacked engines."""
    g0 = jrmat(200, 1600, seed=5)
    for name in ("bfs", "sssp", "pagerank"):
        jg = jalg.prepare_graph(name, g0)
        g = _graph(jg)
        part = _part(jpartition_by_name(partitioner, jg.src, jg.dst, jg.num_nodes, parts))
        before = segment_spmm.launches
        got, it = DistributedEngine(alg.ALGORITHMS[name](), make_engines_mesh(num_engines=parts, device="cpu")).run(
            g, part)
        assert segment_spmm.launches == before  # CPU tensors: the plain version
        one = run(g, alg.ALGORITHMS[name](), max_iterations=it, device="cpu")
        if name == "pagerank":
            assert one.num_iterations == it
            assert float(np.abs(got - one.props).max()) <= PAGERANK_REL * float(one.props.max())
            np.testing.assert_allclose(got, jalg.reference_pagerank(jg), atol=JAX_BOUNDS["pagerank"])
        else:
            assert np.array_equal(got, one.props)
            ref = jalg.reference_bfs(jg, 0) if name == "bfs" else jalg.reference_sssp(jg, 0)
            np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_gloo_backend_is_bit_equal_to_stacked(tmp_path):
    """One spawned gloo run of 4 ranks, engine p on rank PERMUTATION[p]; every
    rank returns the whole result, equal to the stacked backend's bits."""
    assert not np.array_equal(PERMUTATION, np.arange(WORLD))
    ranks = run_gloo("engine", tmp_path)
    want = engine_runs(make_engines_mesh(num_engines=WORLD, device="cpu"))
    assert set(ranks[0]) == set(want)
    for r, got in enumerate(ranks):
        for k, v in want.items():
            assert np.array_equal(got[k], v), (r, k)
    assert int(want["powerlaw/pagerank/iterations"]) > 1
    assert not torch.distributed.is_initialized()


def test_the_stacked_mesh_swaps_and_folds_in_engine_order():
    mesh = make_engines_mesh(num_engines=3, device="cpu")
    x = torch.arange(3 * 3 * 2, dtype=torch.float32).view(3, 3, 2)
    y = mesh.all_to_all(x)
    for i in range(3):
        for j in range(3):
            assert torch.equal(y[j, i], x[i, j])  # engine j receives row j of sender i
    v = torch.tensor([1e8, 1.0, -1e8])
    assert float(mesh.psum(v)) == float((np.float32(1e8) + np.float32(1.0)) + np.float32(-1e8))
    assert torch.equal(fold(x, 1, "min"), x.amin(dim=1))
    assert mesh.local_engines.tolist() == [0, 1, 2] and mesh.axis_names == ("engines",)


def test_make_engines_mesh_checks_its_arguments():
    assert make_engines_mesh([1, 0, 2], device="cpu").num_engines == 3
    with pytest.raises(ValueError, match="not a permutation"):
        make_engines_mesh([0, 0, 2], device="cpu")
    with pytest.raises(ValueError, match="unknown mesh backend"):
        make_engines_mesh(device="cpu", backend="mpi")
    with pytest.raises(RuntimeError, match="initialised by the caller"):
        make_engines_mesh(device="cpu", backend="process_group")
    g = interop.host_graph(4, np.array([0, 1]), np.array([1, 2]))
    part = _part(jpartition_by_name("range", g.src, g.dst, 4, 2))
    with pytest.raises(ValueError, match="2 engines, the mesh has 1"):
        DistributedEngine(alg.bfs_program(), EngineMesh(1, torch.device("cpu"))).run(g, part)


def test_the_example_prints_the_reference_mappers_lines():
    from repro.core.mapping import DeviceMapper
    from repro.core.partition import random_partition
    from repro.core.traffic import traffic_from_partition

    done = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_distributed_graph_analytics.py"),
                           "--device", "cpu"], capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert done.returncode == 0, done.stderr[-2000:]
    lines = done.stdout.strip().splitlines()
    g = jalg.prepare_graph("pagerank", jrmat(2_000, 32_000, seed=1, name="pods"))
    perm, part, h_opt, h_id = DeviceMapper((2, 4)).device_permutation(g.src, g.dst, g.num_nodes)
    assert lines[1] == f"ICI hop count (byte-weighted): identity {h_id:.2f} → optimized {h_opt:.2f}"
    want = []
    for name, p in (("powerlaw", part), ("random", random_partition(g.src, g.dst, g.num_nodes, 8))):
        cross = traffic_from_partition(p, g.src, g.dst, model="cross").bytes_matrix.reshape(4, 8, 4, 8).sum((0, 2))
        want.append(f"  {name:9s}: cross-device bytes/iter = {(cross.sum() - np.trace(cross)) / 1e6:.2f} MB")
    assert lines[-2:] == want
    err = float(lines[2].split("= ")[1])
    assert lines[2].startswith("pagerank: ") and err <= JAX_BOUNDS["pagerank"]
