"""The GNN data path of `repro_torch` against `repro`'s: `GraphBatcher`
(`full_batch`, `sampled_batches`, `molecule_batch`) and `NeighborSampler`
(`sample`, `batches`) give the same arrays, bit for bit and dtype for dtype,
for a seed; `to_device` carries a GNN batch's bool and int32 arrays over
unchanged and passes GIN's `EllBlocks` through."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import GraphBatcher as JaxGraphBatcher
from repro.graph.generators import rmat as jax_rmat
from repro.graph.sampler import NeighborSampler as JaxNeighborSampler
from repro_torch.data.pipeline import GraphBatcher, to_device
from repro_torch.graph.generators import rmat
from repro_torch.graph.sampler import MiniBatch, NeighborSampler
from repro_torch.models import gnn


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _graphs(n, e, seed):
    g, jg = rmat(n, e, seed=seed), jax_rmat(n, e, seed=seed)
    np.testing.assert_array_equal(g.src, jg.src)
    np.testing.assert_array_equal(g.dst, jg.dst)
    return g, jg


@pytest.mark.parametrize("seed", [0, 3])
def test_full_batch_equals_the_reference(seed):
    g, jg = _graphs(500, 4000, seed)
    mine = GraphBatcher(g, d_feat=12, n_classes=7, seed=seed)
    ref = JaxGraphBatcher(jg, d_feat=12, n_classes=7, seed=seed)
    np.testing.assert_array_equal(mine.x, ref.x)
    np.testing.assert_array_equal(mine.labels, ref.labels)
    _equal(mine.full_batch(), ref.full_batch())
    _equal(mine.full_batch(pad_edges=4500, train_frac=0.3), ref.full_batch(pad_edges=4500, train_frac=0.3))


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (4,)])
def test_neighbor_sampler_equals_the_reference(fanouts):
    g, jg = _graphs(800, 6000, 1)
    mine, ref = NeighborSampler(g, fanouts, seed=2), JaxNeighborSampler(jg, fanouts, seed=2)
    seeds = np.arange(0, 800, 37)
    labels = np.arange(800) % 5
    a, b = mine.sample(seeds, labels[seeds]), ref.sample(seeds, labels[seeds])
    assert isinstance(a, MiniBatch) and a.num_seeds == b.num_seeds == a.batch_size
    for f in ("node_ids", "src", "dst", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for a, b in zip(mine.batches(64, num_batches=4, labels=labels), ref.batches(64, num_batches=4, labels=labels)):
        for f in ("node_ids", "src", "dst", "labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.num_seeds == b.num_seeds


def test_sampler_on_a_graph_with_isolated_vertices():
    g, jg = _graphs(300, 400, 5)  # sparse: many vertices with no out-edge
    a = NeighborSampler(g, (6, 4), seed=0).sample(np.arange(0, 300, 3))
    b = JaxNeighborSampler(jg, (6, 4), seed=0).sample(np.arange(0, 300, 3))
    for f in ("node_ids", "src", "dst"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_sampled_batches_equal_the_reference():
    g, jg = _graphs(800, 6000, 4)
    mine = GraphBatcher(g, d_feat=9, n_classes=4, seed=1)
    ref = JaxGraphBatcher(jg, d_feat=9, n_classes=4, seed=1)
    kw = dict(num_batches=3, pad_nodes=900, pad_edges=1500)
    got = list(mine.sampled_batches(NeighborSampler(g, (5, 3), seed=0), 32, **kw))
    want = list(ref.sampled_batches(JaxNeighborSampler(jg, (5, 3), seed=0), 32, **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal(a, b)
    with pytest.raises(ValueError, match="exceeds pad"):
        next(mine.sampled_batches(NeighborSampler(g, (5, 3), seed=0), 32, num_batches=1, pad_nodes=10,
                                  pad_edges=10))


def test_molecule_batch_equals_the_reference():
    g, jg = _graphs(50, 200, 0)
    mine = GraphBatcher(g, d_feat=32, n_classes=16, seed=9)
    ref = JaxGraphBatcher(jg, d_feat=32, n_classes=16, seed=9)
    for _ in range(2):  # the batcher's generator moves on between calls, in both
        _equal(mine.molecule_batch(128, 30, 64), ref.molecule_batch(128, 30, 64))


def test_to_device_keeps_a_gnn_batch_and_passes_the_ell_through():
    g = rmat(200, 1500, seed=0)
    batch = GraphBatcher(g, d_feat=8, n_classes=4).full_batch(pad_edges=1600)
    batch["ell"] = gnn.batch_ell(batch, device="cpu")
    out = to_device(batch, "cpu")
    assert out["ell"] is batch["ell"]
    for k, v in batch.items():
        if k == "ell":
            continue
        assert out[k].dtype == torch.from_numpy(v).dtype, k  # bool, int32, float32 kept
        np.testing.assert_array_equal(out[k].numpy(), v)
    assert out["edge_mask"].dtype == torch.bool and out["src"].dtype == torch.int32
