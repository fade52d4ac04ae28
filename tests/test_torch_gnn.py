"""`repro_torch.models.gnn` against `repro.models.gnn` on the same weights and
batches: gin, gat, pna and graphcast at the `tests/test_models.py::
TestGnnModels` and `tests/test_arch_smoke.py` shapes, and the four archs at
their published widths and depths on `full_graph_sm` (an R-MAT graph of 2,708
nodes and 10,556 edges, d_in 1,433); GIN through both of its sums (the ELL
reduce, `reduce_impl="ell"`, and the reference's gather + scatter).  The JAX
params are carried over by `repro_torch.interop.gnn_params`; the batches are
numpy arrays handed to both.

Tolerance: forward outputs and losses within rtol/atol 1e-4 — float32 on
both sides, the same operations with sums taken in another order (the ELL
reduce adds a vertex's in-edges in ELL slot order, XLA's `segment_sum` in its
own), through up to 16 layers with LayerNorm; the largest difference seen is
1.4e-5 (pna at full width).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNN_SHAPES as JAX_GNN_SHAPES
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import gnn as jgnn
from repro_torch import interop
from repro_torch.configs.base import GNN_SHAPES, N_CLASSES_DEFAULT
from repro_torch.configs.registry import PENDING, arch_ids, get_arch
from repro_torch.data.pipeline import GraphBatcher
from repro_torch.graph.generators import rmat
from repro_torch.graph.structs import HostGraph, build_ell
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.models import gnn

TOL = dict(rtol=1e-4, atol=1e-4)
GNN_ARCHS = ["gin-tu", "graphcast", "gat-cora", "pna"]
PNA_KW = dict(aggregators=("mean", "max", "min", "std"), scalers=("identity", "amplification", "attenuation"))
KINDS = {"gin": {}, "gat": dict(n_heads=4), "pna": PNA_KW}


# ------------------------------------------------------------------ helpers


def _pair_cfg(kind, **kw):
    return jgnn.GnnConfig(kind, kind, **kw), gnn.GnnConfig(kind, kind, **kw)


def _params(jcfg, cfg, seed=0):
    jp = jax.jit(lambda k: jgnn.init_params(jcfg, k))(jax.random.key(seed))
    return jp, interop.gnn_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _node_batch(n=40, e=120, d=8, classes=5, seed=0):
    """TestGnnModels' batch, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((n, d)).astype(np.float32),
        src=rng.integers(0, n, e).astype(np.int32),
        dst=rng.integers(0, n, e).astype(np.int32),
        edge_mask=np.ones(e, bool),
        node_mask=np.ones(n, bool),
        labels=rng.integers(0, classes, n).astype(np.int32),
        train_mask=np.ones(n, bool),
    )


def _graphcast_batch(n, d_in, d_out, seed=0):
    """test_arch_smoke's graphcast batch: grid nodes, the planned mesh, random
    g2m/m2m/m2g edges and edge features, drawn with numpy."""
    rng = np.random.default_rng(seed)
    plan = gnn.graphcast_mesh_plan(n, 6)
    m = plan["n_mesh"]
    b = dict(
        x=rng.standard_normal((n, d_in)).astype(np.float32),
        mesh_x=rng.standard_normal((m, 3)).astype(np.float32),
        labels=rng.standard_normal((n, d_out)).astype(np.float32),
        node_mask=np.ones(n, bool),
    )
    for pre, cnt, ns, nd in (("g2m", plan["e_g2m"], n, m), ("m2m", plan["e_m2m"], m, m),
                             ("m2g", plan["e_m2g"], m, n)):
        b[f"{pre}_src"] = rng.integers(0, ns, cnt).astype(np.int32)
        b[f"{pre}_dst"] = rng.integers(0, nd, cnt).astype(np.int32)
        b[f"{pre}_feat"] = rng.standard_normal((cnt, 4)).astype(np.float32)
        b[f"{pre}_mask"] = np.ones(cnt, bool)
    return b


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch, cfg):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cfg.kind == "gin" and cfg.reduce_impl == "ell":
        out["ell"] = gnn.batch_ell(out, device="cpu")
    return out


def _check_pair(jp, jcfg, tp, cfg, batch, *, routes=("ell", "scatter")):
    """forward and loss_fn of both packages on one batch; GIN through each route."""
    ref = jax.jit(lambda p, b: (jgnn.forward(p, b, jcfg), jgnn.loss_fn(p, b, jcfg)))
    want, want_loss = ref(jp, _jax(batch))
    want, want_loss = np.asarray(want), float(want_loss)
    assert np.isfinite(want).all()
    for route in routes if cfg.kind == "gin" else ("ell",):
        c = gnn.dataclasses.replace(cfg, reduce_impl=route)
        tb = _torch(batch, c)
        got = gnn.forward(tp, tb, c)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(float(gnn.loss_fn(tp, tb, c)), want_loss, **TOL)


# ------------------------------------------------------------------ configs


def test_the_gnn_archs_are_ported():
    assert sorted(arch_ids("gnn")) == sorted(GNN_ARCHS)
    assert not set(GNN_ARCHS) & set(PENDING)
    assert GNN_SHAPES == JAX_GNN_SHAPES and N_CLASSES_DEFAULT == 16
    for a in GNN_ARCHS:
        mine, ref = get_arch(a), jax_get_arch(a)
        for f in ("name", "kind", "n_layers", "d_hidden", "n_heads", "aggregators", "scalers",
                  "mesh_refinement", "n_vars", "source", "family"):
            assert getattr(mine, f) == getattr(ref, f), (a, f)
        assert mine.shape_cells() == ref.shape_cells()
        for built, want in ((mine.smoke_config(), ref.smoke_config()),
                            *((mine.model_config(c), ref.model_config(c)) for c in GNN_SHAPES)):
            for f in ("name", "kind", "n_layers", "d_hidden", "d_in", "d_out", "task", "n_heads",
                      "aggregators", "scalers", "mean_log_degree", "gin_eps_learnable",
                      "mesh_refinement", "n_vars"):
                assert getattr(built, f) == getattr(want, f), (a, f)
            assert built.reduce_impl == "ell"


@pytest.mark.parametrize("cell", list(GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_num_params_flops_and_counts_equal_the_reference(arch, cell):
    mine, ref = get_arch(arch), jax_get_arch(arch)
    assert mine.model_config(cell).num_params == ref.model_config(cell).num_params
    assert mine.model_flops(cell) == ref.model_flops(cell)
    for n_dev in (1, 8, 256):
        assert mine._node_edge_counts(cell, n_dev) == ref._node_edge_counts(cell, n_dev)


def test_published_param_counts():
    assert get_arch("gin-tu").model_config("full_graph_sm").num_params == 130_581
    assert get_arch("gin-tu").model_config("ogb_products").num_params == 45_269
    assert get_arch("graphcast").model_config("full_graph_sm").num_params == 35_524_550


def test_graphcast_mesh_plan_equals_the_reference():
    for r in range(9):
        assert gnn.mesh_sizes_for_refinement(r) == jgnn.mesh_sizes_for_refinement(r)
    grids = sorted({*range(0, 700, 7), 11, 12, 41, 42, 161, 162, 641, 642, 2561, 2562, 2708, 10241,
                    10242, 40962, 163842, 232_965, 655_362, 2_449_029})
    for n in grids:
        for max_r in range(8):
            assert gnn.graphcast_mesh_plan(n, max_r) == jgnn.graphcast_mesh_plan(n, max_r), (n, max_r)
    assert gnn.graphcast_mesh_plan(2708, 6) == {"refinement": 4, "n_mesh": 2562, "e_m2m": 20460,
                                                "e_g2m": 10832, "e_m2g": 8124}


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_params_follows_the_references_rules(arch):
    cfg = get_arch(arch).model_config("molecule")
    jcfg = jax_get_arch(arch).model_config("molecule")
    jp = jax.eval_shape(lambda k: jgnn.init_params(jcfg, k), jax.random.key(0))
    p = gnn.init_params(cfg, 0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == jax.tree.map(lambda t: tuple(t.shape), p)
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    assert sum(t.numel() for _, t in flat) == cfg.num_params
    for path, t in flat:
        name = path[-1].key
        if t.dim() == 0 or name.startswith("b"):
            assert bool((t == 0).all()), name
        elif t.dim() == 1:
            assert bool((t == 1).all()), name
        else:
            assert 0.5 < float(t.std() * np.sqrt(t.shape[-2])) < 1.5, name  # fan-in normal
    again, other = gnn.init_params(cfg, 0, device="cpu"), gnn.init_params(cfg, 1, device="cpu")
    mats = lambda q: [t for _, t in jax.tree_util.tree_flatten_with_path(q)[0] if t.dim() == 2]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(mats(p), mats(again)))  # seeded
    assert not torch.equal(mats(p)[0], mats(other)[0])


def test_interop_refuses_a_wrong_tree():
    jcfg, cfg = _pair_cfg("gin", n_layers=2, d_hidden=16, d_in=8, d_out=5)
    tree = jax.tree.map(np.asarray, jgnn.init_params(jcfg, jax.random.key(0)))
    with pytest.raises(ValueError, match="want a list of 2"):
        interop.gnn_params(dict(tree, layers=tree["layers"][:1]), cfg, device="cpu")
    bad = dict(tree, head={"w": tree["head"]["w"]})
    with pytest.raises(ValueError, match="keys"):
        interop.gnn_params(bad, cfg, device="cpu")
    bad = dict(tree, head={"w": tree["head"]["w"].T, "b": tree["head"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        interop.gnn_params(bad, cfg, device="cpu")
    p = interop.gnn_params(tree, cfg, device="cpu")
    assert p["layers"][0]["eps"].shape == () and p["layers"][0]["eps"].dtype == torch.float32


# ------------------------------------------------------------------ forwards


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_and_loss_match_the_reference(kind):
    """TestGnnModels' shapes: 2 layers, d_hidden 16, d_in 8, 5 classes."""
    jcfg, cfg = _pair_cfg(kind, n_layers=2, d_hidden=16, d_in=8, d_out=5, **KINDS[kind])
    jp, tp = _params(jcfg, cfg)
    for seed in (0, 1):
        _check_pair(jp, jcfg, tp, cfg, _node_batch(seed=seed))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_smoke_configs_match_the_reference(arch):
    """test_arch_smoke's shapes: each arch's smoke_config on 30 nodes."""
    jcfg, cfg = jax_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp, tp = _params(jcfg, cfg)
    if cfg.kind == "graphcast":
        batch = _graphcast_batch(30, cfg.d_in, cfg.d_out)
    else:
        batch = _node_batch(n=30, e=80, d=cfg.d_in, classes=cfg.d_out, seed=1)
    _check_pair(jp, jcfg, tp, cfg, batch)


def test_graphcast_epd_matches_the_reference():
    """test_models' encode-process-decode: 300 grid nodes, the mesh capped below them."""
    kw = dict(n_layers=2, d_hidden=16, d_in=8, d_out=8, task="regression", n_vars=8)
    jcfg, cfg = _pair_cfg("graphcast", **kw)
    jp, tp = _params(jcfg, cfg)
    batch = _graphcast_batch(300, 8, 8, seed=2)
    assert batch["mesh_x"].shape[0] <= 300
    _check_pair(jp, jcfg, tp, cfg, batch)


def _full_graph_sm_batch(cfg):
    sh = GNN_SHAPES["full_graph_sm"]
    if cfg.kind == "graphcast":
        return _graphcast_batch(sh["n_nodes"], cfg.d_in, cfg.d_out)
    g = rmat(sh["n_nodes"], sh["n_edges"], seed=0)
    return GraphBatcher(g, d_feat=cfg.d_in, n_classes=cfg.d_out).full_batch()


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_published_width_on_full_graph_sm(arch):
    """The published width and depth (graphcast: 16 layers of 512, its mesh at
    refinement 4) on the graph size the reference's trainer uses for it."""
    jcfg, cfg = jax_get_arch(arch).model_config("full_graph_sm"), get_arch(arch).model_config("full_graph_sm")
    jp, tp = _params(jcfg, cfg)
    batch = _full_graph_sm_batch(cfg)
    if cfg.kind != "graphcast":
        assert batch["x"].shape == (2708, 1433) and batch["src"].shape == (10556,)
    _check_pair(jp, jcfg, tp, cfg, batch)


# ------------------------------------------------------------------ GIN's sum


def _directed_batch(d=8, seed=0):
    """A directed, asymmetric graph with multi-edges, vertices of in-degree 0,
    masked edges between real vertices and sentinel padding edges."""
    rng = np.random.default_rng(seed)
    n = 50
    src = rng.integers(0, n, 200)
    dst = rng.integers(0, 35, 200)  # vertices 35..49 have in-degree 0 (but out-edges)
    src = np.concatenate([src, [3, 3, 3, 9, 9]])  # multi-edges 3→20 (×3) and 9→21 (×2)
    dst = np.concatenate([dst, [20, 20, 20, 21, 21]])
    mask = np.ones(src.size, bool)
    mask[rng.choice(src.size, 30, replace=False)] = False  # masked, real endpoints
    pad = 25  # sentinel padding
    return dict(
        x=rng.standard_normal((n, d)).astype(np.float32),
        src=np.concatenate([src, np.full(pad, n)]).astype(np.int32),
        dst=np.concatenate([dst, np.full(pad, n)]).astype(np.int32),
        edge_mask=np.concatenate([mask, np.zeros(pad, bool)]),
        node_mask=np.ones(n, bool),
        labels=rng.integers(0, 5, n).astype(np.int32),
        train_mask=rng.random(n) < 0.6,
    )


def test_gin_routes_agree_on_a_directed_graph_with_multi_edges_and_masks():
    batch = _directed_batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ell = gnn.batch_ell(tb, device="cpu")
    n = batch["x"].shape[0]
    h = tb["x"]
    m = batch["edge_mask"]
    want = np.zeros((n, h.shape[1]), np.float32)
    np.add.at(want, batch["dst"][m], batch["x"][batch["src"][m]])
    got = segment_spmm(h, ell)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert bool((got[35:] == 0).all())  # in-degree 0
    # the ELL must be of the reversed graph: the other direction gives other sums
    wrong = build_ell(HostGraph(n, batch["src"][m], batch["dst"][m]), device="cpu")
    assert not torch.allclose(segment_spmm(h, wrong), got)
    # equal from numpy arrays and from tensors
    again = gnn.batch_ell(batch, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.cols, ell.cols)) and again.widths == ell.widths
    assert again.weights is None  # every weight 1

    jcfg, cfg = _pair_cfg("gin", n_layers=3, d_hidden=16, d_in=8, d_out=5)
    jp, tp = _params(jcfg, cfg)
    before = segment_spmm.launches
    _check_pair(jp, jcfg, tp, cfg, batch)
    assert segment_spmm.launches == before  # CPU tensors take the plain version: no kernel launch


def test_gin_without_the_batch_ell_raises():
    cfg = gnn.GnnConfig("gin", "gin", n_layers=2, d_hidden=16, d_in=8, d_out=5)
    params = gnn.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _node_batch().items()}
    with pytest.raises(ValueError, match="batch_ell"):
        gnn.forward(params, batch, cfg)
    with pytest.raises(ValueError, match="unknown reduce_impl"):
        gnn.forward(params, batch, gnn.dataclasses.replace(cfg, reduce_impl="csr"))
    out = gnn.forward(params, batch, gnn.dataclasses.replace(cfg, reduce_impl="scatter"))
    assert out.shape == (40, 5)


@pytest.mark.parametrize("kind,route", [("gin", "ell"), ("gin", "scatter"), ("gat", "ell"), ("pna", "ell")])
def test_padded_edges_have_no_effect(kind, route):
    """Masked sentinel edges appended to a batch change nothing."""
    cfg = gnn.GnnConfig(kind, kind, n_layers=2, d_hidden=16, d_in=8, d_out=5, reduce_impl=route, **KINDS[kind])
    params = gnn.init_params(cfg, 0, device="cpu")
    b = _node_batch()
    b2 = dict(b, src=np.concatenate([b["src"], np.full(30, 40, np.int32)]),
              dst=np.concatenate([b["dst"], np.full(30, 40, np.int32)]),
              edge_mask=np.concatenate([b["edge_mask"], np.zeros(30, bool)]))
    out1 = gnn.forward(params, _torch(b, cfg), cfg)
    out2 = gnn.forward(params, _torch(b2, cfg), cfg)
    torch.testing.assert_close(out1, out2, rtol=1e-5, atol=1e-5)


def test_segment_softmax_is_normalised_and_equals_the_reference():
    rng = np.random.default_rng(0)
    for shape in ((20,), (20, 3)):
        scores = rng.standard_normal(shape).astype(np.float32)
        seg = rng.integers(0, 5, 20).astype(np.int32)
        mask = rng.random(20) < 0.8
        m = mask if len(shape) == 1 else mask[:, None]
        want = np.asarray(jgnn.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 6, jnp.asarray(m)))
        got = gnn.segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg), 6, torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        assert np.isfinite(got.numpy()).all() and bool((got.numpy()[~mask] == 0).all())
        sums = np.zeros((6, *shape[1:]), np.float32)
        np.add.at(sums, seg[mask], got.numpy()[mask])
        present = np.bincount(seg[mask], minlength=6) > 0
        np.testing.assert_allclose(sums[present], 1.0, rtol=1e-5)
        assert bool((sums[~present] == 0).all())  # the sentinel row 5 and empty segments


def test_pna_aggregators_on_empty_segments():
    """max/min of an empty segment are ∓inf before the forward maps them to
    0; std is sqrt(eps); a PNA forward over a batch whose edges are all
    masked, and one with in-degree-0 vertices, equals the reference's."""
    data = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
    seg = torch.tensor([0, 0])
    assert gnn._seg_extreme(data, seg, 3, "amax").tolist() == [[3.0, 4.0], [float("-inf")] * 2, [float("-inf")] * 2]
    assert gnn._seg_extreme(data, seg, 3, "amin").tolist() == [[1.0, -2.0], [float("inf")] * 2, [float("inf")] * 2]
    jcfg, cfg = _pair_cfg("pna", n_layers=2, d_hidden=16, d_in=8, d_out=5, **PNA_KW)
    jp, tp = _params(jcfg, cfg)
    _check_pair(jp, jcfg, tp, cfg, _directed_batch())
    b = _node_batch()
    b["edge_mask"][:] = False
    _check_pair(jp, jcfg, tp, cfg, b)
    out = gnn.pna_forward(tp, _torch(b, cfg), cfg)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kind", list(KINDS))
def test_molecule_graph_class_pooling_matches_the_reference(kind):
    """Graph classification: node embeddings summed a graph (`graph_ids`),
    then the head; GraphBatcher.molecule_batch, as the `molecule` cell."""
    jcfg, cfg = _pair_cfg(kind, n_layers=2, d_hidden=16, d_in=6, d_out=3, task="graph_class", **KINDS[kind])
    jp, tp = _params(jcfg, cfg)
    batch = GraphBatcher(rmat(20, 60, seed=0), d_feat=6, n_classes=3, seed=1).molecule_batch(5, 7, 12)
    _check_pair(jp, jcfg, tp, cfg, batch)
    tb = _torch(batch, cfg)
    assert gnn.forward(tp, tb, cfg).shape == (5, 3)
