"""`repro_torch.graph.halo` and `repro_torch.models.gnn_dist` against
`repro.graph.halo` and `repro.models.gnn_dist` on the same seeded graphs,
features and weights (`interop.gnn_params`):

* `build_halo_plan` (the default Algorithm-2 partition and the four
  partitioners' vertex parts) and `pack_batch` bit-equal to the reference's
  at P ∈ {1, 4, 8};
* `gin_forward_halo` at P = 4 and 8 stacked engines against
  `repro.models.gnn.forward` on the whole graph, within the reference's own
  2e-4 (`tests/test_multidevice_subprocess.py:93`), and at P = 1 against the
  reference's `gin_forward_halo` and `gin_halo_loss_fn` on its one-device
  mesh, within the same 2e-4 (float32 on both sides, the neighbour sums in
  another order through 3 layers with LayerNorm);
* the "process_group" backend over gloo (4 spawned ranks, a permutation that
  is not the identity) bit-equal to the stacked one, logits and loss;
* a batch without the plan's ELL raises.  Training: `tests/test_torch_halo_train.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _hypothesis_compat import given, settings, st
from _torch_mesh_runs import WORLD, halo_runs, run_gloo
from repro.core.partition import partition_by_name as jpartition_by_name
from repro.graph.generators import rmat as jrmat
from repro.graph.halo import build_halo_plan as jbuild_halo_plan
from repro.graph.halo import plan_sizes as jplan_sizes
from repro.models import gnn as jgnn
from repro.models import gnn_dist as jgnn_dist
from repro_torch import interop
from repro_torch.graph.distributed import make_engines_mesh
from repro_torch.graph.halo import build_halo_plan, halo_extend, plan_sizes
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.models import gnn
from repro_torch.models.gnn_dist import gin_forward_halo, gin_halo_loss_fn, pack_batch, shard_batch

TOL = 2e-4  # tests/test_multidevice_subprocess.py:93
PARTITIONERS = ("powerlaw", "random", "range", "hash")
PLAN_FIELDS = ("send_idx", "src_slot", "dst_slot", "slot_to_vertex")


def _assert_plan_equal(src, dst, n, parts, vertex_part=None):
    want = jbuild_halo_plan(src, dst, n, parts, vertex_part=vertex_part)
    got = build_halo_plan(src, dst, n, parts, vertex_part=vertex_part)
    assert plan_sizes(got) == jplan_sizes(want)
    assert got.halo_bytes_per_device(100) == want.halo_bytes_per_device(100)
    for f in PLAN_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return got, want


@pytest.mark.parametrize("partitioner", (None, *PARTITIONERS))
@pytest.mark.parametrize("parts", [1, 4, 8])
def test_plan_and_pack_are_bit_equal_to_the_reference(parts, partitioner):
    g = jrmat(120, 900, seed=4)
    vp = None if partitioner is None else jpartition_by_name(partitioner, g.src, g.dst, 120, parts).vertex_part
    got, want = _assert_plan_equal(g.src, g.dst, 120, parts, vp)
    rng = np.random.default_rng(parts)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    labels, mask = rng.integers(0, 5, 120), rng.random(120) < 0.5
    a, b = pack_batch(got, x, labels, mask), jgnn_dist.pack_batch(want, x, labels, mask)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), parts=st.integers(1, 9))
def test_plan_is_bit_equal_on_random_graphs(seed, parts):
    g = jrmat(40 + seed % 90, 200 + seed % 700, seed=seed)
    _assert_plan_equal(g.src, g.dst, g.num_nodes, parts)


def _model(n_layers=3):
    jcfg = jgnn.GnnConfig("gin", "gin", n_layers=n_layers, d_hidden=16, d_in=8, d_out=5)
    cfg = gnn.GnnConfig("gin", "gin", n_layers=n_layers, d_hidden=16, d_in=8, d_out=5)
    jp = jgnn.init_params(jcfg, jax.random.key(0))
    return jcfg, cfg, jp, interop.gnn_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _inputs(n=120):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 8)).astype(np.float32), rng.integers(0, 5, n).astype(np.int32),
            rng.random(n) < 0.6)


def _to_vertices(plan, out):
    got = np.zeros((plan.num_nodes, out.shape[-1]), np.float32)
    ok = plan.slot_to_vertex >= 0
    got[plan.slot_to_vertex[ok]] = out[ok]
    return got


@pytest.mark.parametrize("parts", [4, 8])
def test_halo_gin_equals_the_reference_global_forward(parts):
    """tests/test_multidevice_subprocess.py:93 on stacked engines."""
    g = jrmat(120, 900, seed=4)
    jcfg, cfg, jp, params = _model()
    x, labels, train = _inputs()
    ref = jgnn.forward(jp, dict(x=jnp.asarray(x), src=jnp.asarray(g.src.astype(np.int32)),
                                dst=jnp.asarray(g.dst.astype(np.int32)), edge_mask=jnp.ones(g.num_edges, bool),
                                node_mask=jnp.ones(120, bool), labels=jnp.asarray(labels),
                                train_mask=jnp.asarray(train)), jcfg)
    plan = build_halo_plan(g.src, g.dst, 120, parts)
    mesh = make_engines_mesh(num_engines=parts, device="cpu")
    batch = shard_batch(pack_batch(plan, x, labels, train), mesh)
    before = segment_spmm.launches
    with torch.no_grad():
        out = gin_forward_halo(params, batch, cfg, mesh)
    assert segment_spmm.launches == before and out.shape == (parts, plan.n_local, 5)
    assert float(np.abs(_to_vertices(plan, out.numpy()) - np.asarray(ref)).max()) < TOL


def test_one_engine_equals_the_reference_halo_forward_and_loss():
    g = jrmat(120, 900, seed=4)
    jcfg, cfg, jp, params = _model()
    x, labels, train = _inputs()
    jplan = jbuild_halo_plan(g.src, g.dst, 120, 1)
    jbatch = {k: jnp.asarray(v) for k, v in jgnn_dist.pack_batch(jplan, x, labels, train).items()}
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("engines",))
    with jax.set_mesh(jmesh):
        want = np.asarray(jax.jit(lambda p, b: jgnn_dist.gin_forward_halo(p, b, jcfg, jmesh))(jp, jbatch))
        want_loss = float(jax.jit(lambda p, b: jgnn_dist.gin_halo_loss_fn(p, b, jcfg, jmesh))(jp, jbatch))
    plan = build_halo_plan(g.src, g.dst, 120, 1)
    mesh = make_engines_mesh(device="cpu")
    batch = shard_batch(pack_batch(plan, x, labels, train), mesh)
    with torch.no_grad():
        got = gin_forward_halo(params, batch, cfg, mesh).numpy()
        loss = float(gin_halo_loss_fn(params, batch, cfg, mesh))
    assert float(np.abs(got - want).max()) < TOL
    assert abs(loss - want_loss) < TOL and np.isfinite(loss)


def test_gloo_backend_is_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("halo", tmp_path)
    want = halo_runs(make_engines_mesh(num_engines=WORLD, device="cpu"))
    seen = []
    for got in ranks:
        (e,) = got["engines"].tolist()
        seen.append(e)
        assert np.array_equal(got["logits"][0], want["logits"][e]), e
        assert np.array_equal(got["loss"], want["loss"])
    assert sorted(seen) == list(range(WORLD)) and np.isfinite(want["loss"])
    assert not torch.distributed.is_initialized()


def test_halo_extend_sends_the_asked_rows_and_zero_for_padding():
    mesh = make_engines_mesh(num_engines=2, device="cpu")
    x = torch.arange(2 * 3 * 2, dtype=torch.float32).view(2, 3, 2) + 1
    send_idx = torch.tensor([[[3, 3], [2, 3]], [[0, 1], [3, 3]]])  # (q, p, h): 3 = n_local pads
    ext = halo_extend(x, send_idx, mesh)
    assert ext.shape == (2, 3 + 2 * 2, 2)
    assert torch.equal(ext[:, :3], x)
    assert torch.equal(ext[0, 3:5], torch.zeros(2, 2))  # engine 0 asked nothing of itself
    assert torch.equal(ext[0, 5:7], x[1, [0, 1]])  # … and rows 0, 1 of engine 1
    assert torch.equal(ext[1, 3:5], torch.stack([x[0, 2], torch.zeros(2)]))
    assert torch.equal(ext[1, 5:7], torch.zeros(2, 2))


def test_the_halo_path_needs_the_plans_ell():
    """The forward reads the plan's ELL (`shard_batch`); a batch without it raises."""
    g = jrmat(120, 900, seed=4)
    _, cfg, _, params = _model(n_layers=1)
    x, labels, train = _inputs()
    mesh = make_engines_mesh(num_engines=4, device="cpu")
    batch = shard_batch(pack_batch(build_halo_plan(g.src, g.dst, 120, 4), x, labels, train), mesh)
    with torch.no_grad():
        assert torch.isfinite(gin_halo_loss_fn(params, batch, cfg, mesh))
        with pytest.raises(ValueError, match="shard_batch"):
            gin_forward_halo(params, {k: v for k, v in batch.items() if k != "ell"}, cfg, mesh)
