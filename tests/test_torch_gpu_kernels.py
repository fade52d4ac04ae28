"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and skips on a machine without a
CUDA device (a CUDA kernel has no host mode).  This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.generators import rmat
from repro_torch.graph.structs import HostGraph, build_ell
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
from repro_torch.kernels.segment_spmm.ref import coo_spmm_ref, ell_spmm_ref, segment_spmm_ref

TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of an fp32 sum
SHAPES = [(50, 16, 8, 128), (100, 7, 3, 64), (30, 4, 16, 16), (64, 32, 1, 256), (40, 9, 8, 1),
          (300, 5, 1500, 1), (300, 5, 1500, 3), (90, 33, 40, 20)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernel has no host mode")


def _inputs(n, r, w, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cols = rng.integers(0, n + 10, (r, w)).astype(np.int32)  # >= n hits padding
    wts = rng.standard_normal((r, w)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(cols).cuda(), torch.from_numpy(wts).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("with_wts", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,R,W,D", SHAPES)
def test_kernel_matches_plain_version(N, R, W, D, dtype, with_wts):
    _need_card()
    x, cols, wts = _inputs(N, R, W, D)
    x, wts = x.to(dtype), (wts if with_wts else None)
    before = ell_spmm.launches
    got = ell_spmm(x, cols, wts)
    assert ell_spmm.launches == before + 1
    want = ell_spmm_ref(x, cols, wts)
    assert got.dtype == dtype and got.shape == (R, D)
    torch.testing.assert_close(got.float(), want.float(), **(TOL if dtype == torch.float32 else BF16_TOL))
    assert torch.equal(got, ell_spmm(x, cols, wts))  # one owner per element, fixed order


@pytest.mark.gpu
def test_unaligned_views_take_the_scalar_path():
    _need_card()
    x, cols, wts = _inputs(64, 20, 8, 33)  # D = 33: no 16-byte rows
    torch.testing.assert_close(ell_spmm(x, cols, wts), ell_spmm_ref(x, cols, wts), **TOL)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take():
    _need_card()
    x, cols, wts = _inputs(50, 16, 8, 16)
    with pytest.raises(TypeError):
        ell_spmm(x.double(), cols, wts)
    with pytest.raises(TypeError):
        ell_spmm(x, cols.long(), wts)
    with pytest.raises(ValueError):
        ell_spmm(x, cols.t(), None)  # not contiguous
    with pytest.raises(ValueError):
        ell_spmm(x, cols.cpu(), wts)
    before = ell_spmm.launches
    assert ell_spmm(x, cols[:0], None).shape == (0, 16) and ell_spmm.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_whole_graph_equals_coo_oracle(seed):
    _need_card()
    g = rmat(1500, 20_000, seed=seed, weighted=True)
    ell = build_ell(g.reversed())  # device=None is the card
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1500, 32)).astype(np.float32)).cuda()
    got = segment_spmm(x, ell)
    want = coo_spmm_ref(x, torch.from_numpy(g.src).cuda(), torch.from_numpy(g.dst).cuda(),
                        torch.from_numpy(g.weight).cuda(), 1500)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def _hub_graph(weighted, seed=0):
    """R-MAT on 3,000 vertices, vertex 7 the target of 1,500 more edges (an
    ELL row of width 2,048: a hub), and 40 vertices with no edge at all."""
    g = rmat(3000, 30_000, seed=seed, weighted=weighted)
    rng = np.random.default_rng(seed)
    extra = rng.choice(3000, 1500, replace=False)
    src = np.concatenate([g.src, extra]).astype(g.src.dtype)
    dst = np.concatenate([g.dst, np.full(1500, 7)]).astype(g.dst.dtype)
    w = None if g.weight is None else np.concatenate([g.weight, rng.random(1500).astype(np.float32)])
    return HostGraph(3040, src, dst, w)


def _per_bucket(x, ell):
    """The reduce one bucket a launch, scattered back through a sentinel row."""
    n = x.shape[0]
    out = torch.zeros((n + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    for b in range(ell.num_buckets):
        if ell.cols[b].shape[0]:
            wts = ell.weights[b] if ell.weights is not None else None
            out[ell.rows[b].long().clamp(max=n)] = ell_spmm(x, ell.cols[b], wts)
    return out[:n]


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 16, 64])
def test_fused_reduce_equals_the_per_bucket_route(d, dtype, weighted):
    _need_card()
    g = _hub_graph(weighted)
    ell = build_ell(g.reversed())
    assert max(ell.widths) >= 1024 and ell.work().zero_rows.numel() >= 40
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((g.num_nodes, d)).astype(np.float32)).cuda()
    x = x.to(dtype)
    before = segment_spmm.launches
    got = segment_spmm(x, ell)
    assert segment_spmm.launches == before + 1  # one launch a reduce
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, _per_bucket(x, ell))  # same lanes, same order: the same bits
    assert torch.equal(got, segment_spmm(x, ell))
    isolated = torch.from_numpy(np.setdiff1d(np.arange(g.num_nodes), g.dst)).cuda()
    assert bool((got[isolated] == 0).all())
    want = coo_spmm_ref(x, torch.from_numpy(g.src).cuda(), torch.from_numpy(g.dst).cuda(),
                        None if g.weight is None else torch.from_numpy(g.weight).cuda(), g.num_nodes)
    torch.testing.assert_close(got.float(), want.float(), **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 100, 1433])
def test_fused_reduce_matches_the_plain_version_at_gin_widths(d, dtype):
    """GIN's widths (d_hidden 64, ogb_products' 100, full_graph_sm's 1,433)
    on a graph with a hub row of width 2,048: the block splits the hub row's
    slots when d / V threads leave room for two groups (64, 100), and loops
    over the features when they do not (1,433: V = 1)."""
    _need_card()
    g = _hub_graph(False)
    ell = build_ell(g.reversed())
    assert max(ell.widths) >= 1024
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((g.num_nodes, d)).astype(np.float32)).cuda()
    x = x.to(dtype)
    got = segment_spmm(x, ell)
    assert torch.equal(got, segment_spmm(x, ell)) and torch.equal(got, _per_bucket(x, ell))
    want = segment_spmm_ref(x, ell)
    torch.testing.assert_close(got.float(), want.float(), **(TOL if dtype == torch.float32 else BF16_TOL))
    torch.testing.assert_close(got[7].float(), want[7].float(),  # the hub row
                               **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
def test_gin_gradients_on_the_card_match_the_scatter_route():
    """A GIN training step's gradients through the ELL reduce (its backward
    the same kernel over the transposed ELL) against the scatter route on the
    same weights, within 1e-4 (float32 sums in another order); 5 forward and 4
    backward launches at gin-tu's 5 layers (the input features need no
    gradient).  Without the transpose a gradient is refused before a launch."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.models import gnn

    _need_card()
    cfg = get_arch("gin-tu").model_config("full_graph_sm")
    host = GraphBatcher(rmat(512, 4096, seed=0), d_feat=cfg.d_in, n_classes=cfg.d_out).full_batch()
    batch = to_device(host, "cuda")
    batch["ell"] = gnn.batch_ell(host, device="cuda", transpose=True)
    params = gnn.init_params(cfg, 0, device="cuda")
    leaves = [p.requires_grad_(True) for lp in params["layers"] for p in (lp["mlp"]["w0"], lp["eps"])]
    before = segment_spmm.launches
    got = torch.autograd.grad(gnn.loss_fn(params, batch, cfg), leaves)
    assert segment_spmm.launches - before == 2 * cfg.n_layers - 1
    import dataclasses

    want = torch.autograd.grad(gnn.loss_fn(params, batch, dataclasses.replace(cfg, reduce_impl="scatter")), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    batch["ell"] = gnn.batch_ell(host, device="cuda")
    before = segment_spmm.launches
    with pytest.raises(ValueError, match="no transpose"):
        gnn.loss_fn(params, batch, cfg)
    assert segment_spmm.launches - before == 1  # layer 1's input needs no gradient


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 64, 100])
def test_reduce_gradient_is_the_transposed_reduce(d, dtype):
    """The reduce's gradient on the hub graph (a hub of in-degree 1,500;
    vertices of in- and of out-degree 0) against autograd through the COO
    oracle; one backward launch; two runs bit-equal."""
    _need_card()
    g = _hub_graph(True, seed=d)
    ell = build_ell(g.reversed())
    ell.transpose = build_ell(g)
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((g.num_nodes, d)).astype(np.float32)).cuda().to(dtype)
    dy = torch.from_numpy(rng.standard_normal((g.num_nodes, d)).astype(np.float32)).cuda().to(dtype)
    src, dst, w = (torch.from_numpy(a).cuda() for a in (g.src, g.dst, g.weight))
    xg = x.clone().requires_grad_(True)
    before = segment_spmm.launches
    (got,) = torch.autograd.grad(segment_spmm(xg, ell), xg, dy)
    assert segment_spmm.launches - before == 2
    (again,) = torch.autograd.grad(segment_spmm(xg, ell), xg, dy)
    assert torch.equal(got, again)
    xf = x.float().requires_grad_(True)
    (want,) = torch.autograd.grad(coo_spmm_ref(xf, src, dst, w, g.num_nodes), xf, dy.float())
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, **(TOL if dtype == torch.float32 else BF16_TOL))
    no_out = torch.from_numpy(np.setdiff1d(np.arange(g.num_nodes), g.src)).cuda()
    assert bool((got[no_out] == 0).all())


@pytest.mark.gpu
def test_fused_reduce_refuses_what_the_kernel_does_not_take():
    _need_card()
    g = _hub_graph(True)
    ell = build_ell(g.reversed())
    x = torch.ones((g.num_nodes, 4), device="cuda")
    before = segment_spmm.launches
    with pytest.raises(ValueError):
        segment_spmm(x[:-1], ell)  # not the graph's vertex count
    with pytest.raises(TypeError):
        segment_spmm(x.double(), ell)
    with pytest.raises(ValueError):
        segment_spmm(x.t().contiguous().t(), ell)  # not contiguous
    with pytest.raises(ValueError, match="no transpose"):
        segment_spmm(x.requires_grad_(), ell)
    assert segment_spmm.launches == before


# ------------------------------------------------------------ flash attention

ATTN_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 1, 32), (2, 96, 160, 4, 4, 64),
               (1, 200, 200, 6, 2, 128), (1, 77, 77, 24, 8, 128), (3, 1, 40, 4, 2, 32)]


def _attn_inputs(b, sq, skv, hq, hkv, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda().to(dtype)
            for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh", ATTN_SHAPES)
def test_flash_attention_matches_plain_version(b, sq, skv, hq, hkv, dh, causal, dtype):
    _need_card()
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, dh, dtype)
    off = skv - sq if causal else 0
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **(TOL if dtype == torch.float32 else BF16_TOL))
    assert torch.equal(got, flash_attention(q, k, v, causal=causal, q_offset=off))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_attention_reads_strided_views(dh):
    """q/k/v as views into one packed (B, S, Hq + 2·Hkv, dh) projection."""
    _need_card()
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 130, 12, dh)).astype(np.float32)).cuda().bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,q_offset", [(1, 200, 328, 8, 2, 128), (2, 1000, 1100, 16, 4, 100)])
def test_flash_attention_ragged_lengths_and_offset(b, sq, skv, hq, hkv, q_offset, dh):
    """Sq and Skv not multiples of a tile, kv rows past the causal edge; the
    second case launches 128-row q tiles (two consumer warpgroups)."""
    _need_card()
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, dh, torch.bfloat16, seed=2)
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    want = flash_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(got, flash_attention(q, k, v, causal=True, q_offset=q_offset))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [512, 2048, 3072])
def test_flash_attention_at_the_serve_path_shapes(s):
    """llama3.2-3b prefill: q (1, S, 24, 128), k/v (1, S, 8, 128) bf16, causal."""
    _need_card()
    q, k, v = _attn_inputs(1, s, s, 24, 8, 128, torch.bfloat16, seed=3)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(got, flash_attention(q, k, v, causal=True))  # two runs, the same bits


@pytest.mark.gpu
def test_flash_attention_refuses_what_the_kernel_does_not_take():
    _need_card()
    q, k, v = _attn_inputs(1, 64, 64, 4, 2, 64, torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, kv_valid_len=torch.tensor([10], device="cuda"))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):
        flash_attention(*_attn_inputs(1, 64, 64, 4, 2, 96, torch.bfloat16))  # dh 96
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :1, :], v)  # k and v differ
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k, v)  # dh not contiguous
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    assert flash_attention.launches == before
    got = flash_attention(q, k, v, kv_valid_len=torch.tensor([10], device="cuda"), impl="ref")
    assert got.shape == q.shape and flash_attention.launches == before


# ------------------------------------------------------------ embedding bag

# (T, V, D, B, L): tests/test_kernels.py's four, dcn-v2's D = 16 at a small
# vocab, a D with no 16-byte rows (the scalar path), and bags longer than the
# kernel's gather chunk of 4
BAG_SHAPES = [(3, 64, 128, 4, 5), (2, 32, 16, 8, 1), (1, 100, 256, 2, 7), (4, 17, 8, 3, 2),
              (26, 1000, 16, 512, 1), (3, 50, 33, 7, 3), (2, 40, 8, 9, 9)]


def _bag_inputs(t, v, d, b, l, seed=0):
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.standard_normal((t, v, d)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(-2, v, (b, t, l)).astype(np.int32)).cuda()  # with padding ids
    w = torch.from_numpy(rng.standard_normal((b, t, l)).astype(np.float32)).cuda()
    return tables, ids, w


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,V,D,B,L", BAG_SHAPES)
def test_embedding_bag_matches_plain_version(T, V, D, B, L, dtype, weighted):
    _need_card()
    tables, ids, w = _bag_inputs(T, V, D, B, L)
    tables, w = tables.to(dtype), (w if weighted else None)
    before = embedding_bag.launches
    got = embedding_bag(tables, ids, w)
    assert embedding_bag.launches == before + 1
    want = embedding_bag_ref(tables, ids, w)
    assert got.dtype == dtype and got.shape == (B, T, D)
    torch.testing.assert_close(got.float(), want.float(), **(TOL if dtype == torch.float32 else BF16_TOL))
    assert torch.equal(got, embedding_bag(tables, ids, w))  # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("T,V,D,B,L", BAG_SHAPES[:4])
def test_embedding_bag_gradients_match_autograd_through_the_plain_version(T, V, D, B, L):
    _need_card()
    tables, ids, w = _bag_inputs(T, V, D, B, L, seed=1)
    g = torch.randn((B, T, D), device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    t1, w1 = tables.clone().requires_grad_(), w.clone().requires_grad_()
    before = embedding_bag.launches
    (embedding_bag(t1, ids, w1) * g).sum().backward()
    assert embedding_bag.launches == before + 1  # the forward is the kernel
    t2, w2 = tables.clone().requires_grad_(), w.clone().requires_grad_()
    (embedding_bag_ref(t2, ids, w2) * g).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, **TOL)
    torch.testing.assert_close(w1.grad, w2.grad, **TOL)


@pytest.mark.gpu
def test_embedding_bag_refuses_what_the_kernel_does_not_take():
    _need_card()
    tables, ids, w = _bag_inputs(2, 32, 16, 4, 3)
    before = embedding_bag.launches
    with pytest.raises(TypeError):
        embedding_bag(tables, ids.long())  # int32 ids only, no silent cast
    with pytest.raises(TypeError):
        embedding_bag(tables.double(), ids)
    with pytest.raises(TypeError):
        embedding_bag(tables, ids, w.double())
    with pytest.raises(ValueError):
        embedding_bag(tables, ids, w[..., :2])
    with pytest.raises(ValueError):
        embedding_bag(tables, ids.transpose(0, 2).contiguous().transpose(0, 2))  # not contiguous
    with pytest.raises(ValueError):
        embedding_bag(tables, ids.cpu())
    assert embedding_bag.launches == before
    assert embedding_bag(tables, ids[:0]).shape == (0, 2, 16) and embedding_bag.launches == before
    torch.testing.assert_close(embedding_bag(tables, ids.long(), impl="ref"), embedding_bag(tables, ids))


@pytest.mark.gpu
def test_attention_with_grad_on_the_card_runs_its_backward_kernel():
    """With grad on, attention runs the forward kernel (with its lse) and, in
    backward, the backward kernel: one launch each.  The one-bucket
    `ell_spmm` has no backward and still refuses."""
    _need_card()
    q, k, v = _attn_inputs(1, 64, 64, 4, 2, 64, torch.bfloat16)
    x, cols, wts = _inputs(50, 16, 8, 16)
    q.requires_grad_()
    before = (flash_attention.launches, flash_attention_bwd.launches, ell_spmm.launches)
    out = flash_attention(q, k, v)
    (dq,) = torch.autograd.grad(out.float().sum(), q)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert dq.shape == q.shape and dq.dtype == q.dtype and bool(torch.isfinite(dq.float()).all())
    with pytest.raises(NotImplementedError, match="impl='ref'"):
        ell_spmm(x.requires_grad_(), cols, wts)
    assert ell_spmm.launches == before[2]
    with torch.no_grad():
        assert ell_spmm(x, cols, wts).shape == (16, 16)


# ------------------------------------------------------------ attention backward

ATTN_BWD_SHAPES = [(2, 128, 128, 4, 4, 64), (1, 96, 160, 6, 2, 32), (2, 77, 77, 24, 8, 128),
                   (1, 200, 328, 8, 2, 128), (1, 64, 64, 8, 2, 128), (3, 1, 40, 4, 1, 32)]


def _bwd_case(b, sq, skv, hq, hkv, dh, dtype, causal, q_offset, seed=0):
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, dh, dtype, seed=seed)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    o, lse = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset, with_lse=True)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(o.shape).astype(np.float32))
    return q, k, v, o, do.cuda().to(dtype), lse


def _assert_grads_close(got, want, dtype):
    """float32: within 1e-5 of each gradient's largest magnitude (fp32 sums
    in another order); bfloat16: within 1e-2 of it (the kernel and the plain
    version round one fp32 value each to bf16)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.float().abs().max()) + 1e-6
        err = float((a.float() - b.float()).abs().max())
        assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh", ATTN_BWD_SHAPES)
def test_attention_backward_matches_plain_version(b, sq, skv, hq, hkv, dh, causal, dtype):
    """The backward kernel against `flash_attention_bwd_ref` on the forward
    kernel's output and lse: G = 1, 3 and 4, every head dim, ragged S, the
    kv rows past the causal edge (q_offset = Skv − Sq); two runs bit-equal;
    the lse against the plain version's."""
    _need_card()
    off = skv - sq if causal else 0
    q, k, v, o, do, lse = _bwd_case(b, sq, skv, hq, hkv, dh, dtype, causal, off)
    _, want_lse = flash_attention_ref(q, k, v, causal=causal, q_offset=off, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4 if dtype == torch.float32 else 1e-2)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, q_offset=off)
    _assert_grads_close(got, want, dtype)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # one owner a row, no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset", [-40, 37])
def test_attention_backward_offsets_and_fully_masked_rows(q_offset, dtype):
    """q_offset moves the causal edge; at −40 the first 40 query rows see no
    key: they add no gradient and no NaN."""
    _need_card()
    q, k, v, o, do, lse = _bwd_case(2, 100, 90, 6, 2, 64, dtype, True, q_offset, seed=3)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=True, q_offset=q_offset)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True, q_offset=q_offset)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    _assert_grads_close(got, want, dtype)
    if q_offset < 0:
        assert bool((got[0][:, :-q_offset] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_gradients_match_autograd_of_the_plain_version(causal):
    """float32 gradients of the Function (kernels both ways) against autograd
    through `impl="ref"`, within 1e-5 of each gradient's largest magnitude."""
    _need_card()
    q, k, v = (t.requires_grad_(True) for t in _attn_inputs(2, 150, 150, 6, 2, 64, torch.float32, seed=4))
    do = torch.randn(q.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    got = torch.autograd.grad(flash_attention(q, k, v, causal=causal), (q, k, v), do)
    want = torch.autograd.grad(flash_attention(q, k, v, causal=causal, impl="ref"), (q, k, v), do)
    _assert_grads_close(got, want, torch.float32)


@pytest.mark.gpu
def test_attention_backward_refuses_what_the_kernel_does_not_take():
    _need_card()
    q, k, v, o, do, lse = _bwd_case(1, 64, 64, 4, 2, 64, torch.bfloat16, True, 0)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda

    before = flash_attention_bwd.launches
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, o, do, lse[:, :2])  # lse of another shape
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, k, v, o, do.float(), lse)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, o, do, lse)
    with pytest.raises(NotImplementedError, match="kv_valid_len"):
        flash_attention(q.requires_grad_(), k, v, kv_valid_len=torch.full((1,), 10, device="cuda"))
    assert flash_attention_bwd.launches == before


# ------------------------------------------------------------ the bf16 wgmma backward

# (causal, q_offset): None is Skv − Sq, the causal edge at the last key
WGMMA_BWD_MASKS = [(False, 0), (True, None), (True, -40), (True, 37)]


def _rows_that_see_no_key(sq, causal, q_offset):
    return max(0, min(sq, -q_offset)) if causal else 0


@pytest.mark.gpu
@pytest.mark.parametrize("causal,q_offset", WGMMA_BWD_MASKS)
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_wgmma_backward_matches_plain_version(g, dh, causal, q_offset):
    """The bf16 route (`attn_bwd_dkdv_wgmma`, `attn_bwd_dq_wgmma`) against
    `flash_attention_bwd_ref` on the same forward: G = 1, 3, 4, every head
    dim, Sq ≠ Skv and neither a multiple of 64, causal and not, the causal
    edge moved by q_offset −40 (40 rows see no key: zero dQ, no NaN) and 37;
    within 1e-2 of each gradient's largest magnitude; two runs bit-equal."""
    _need_card()
    b, sq, skv, hkv = 2, 77, 131, 2
    off = skv - sq if q_offset is None else q_offset
    q, k, v, o, do, lse = _bwd_case(b, sq, skv, g * hkv, hkv, dh, torch.bfloat16, causal, off, seed=g + dh)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, q_offset=off)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    _assert_grads_close(got, want, torch.bfloat16)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # one owner a row, no atomics
    blind = _rows_that_see_no_key(sq, causal, off)
    assert bool((got[0][:, :blind] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_backward_with_two_consumer_warpgroups(causal):
    """A shape large enough that the dQ kernel takes 128-row tiles (two
    consumer warpgroups a block), ragged at both ends."""
    _need_card()
    from repro_torch.kernels.flash_attention.kernel import bwd_consumer_groups

    b, sq, skv, hq, hkv, dh = 2, 1000, 1100, 24, 8, 128
    assert bwd_consumer_groups(b, sq, skv, hq, hkv) == {"dkdv": 2, "dq": 2}
    off = skv - sq if causal else 0
    q, k, v, o, do, lse = _bwd_case(b, sq, skv, hq, hkv, dh, torch.bfloat16, causal, off, seed=5)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, q_offset=off)
    _assert_grads_close(got, want, torch.bfloat16)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_bf16_backward_runs_the_wgmma_kernels():
    """A bf16 call runs the delta kernel and the two wgmma kernels and no FMA
    kernel, a float32 call the FMA kernels: by the library's own launch
    counts and by the profiler's kernel names.  Both are held to 168 registers
    a thread by their 9 or 10 warps an SM: the dK/dV kernel spills nothing,
    the dQ kernel nothing below dh = 128 and at most 32 bytes a thread at
    128."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.kernel import bwd_kernel_info, bwd_kernel_launches

    def kernel_names(dtype):
        q, k, v, o, do, lse = _bwd_case(1, 128, 128, 4, 2, 64, dtype, True, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            before = bwd_kernel_launches()
            flash_attention_bwd(q, k, v, o, do, lse, causal=True)
            counted = {n: c - before[n] for n, c in bwd_kernel_launches().items()}
            torch.cuda.synchronize()
        wgmma = dtype == torch.bfloat16
        assert counted == {"attn_bwd_delta": 1, "attn_bwd_dkdv_wgmma": int(wgmma), "attn_bwd_dq_wgmma": int(wgmma),
                           "attn_bwd_dkdv": int(not wgmma), "attn_bwd_dq": int(not wgmma)}, counted
        return {e.key for e in prof.key_averages() if "attn_bwd" in e.key}

    bf16 = kernel_names(torch.bfloat16)
    assert any("attn_bwd_dkdv_wgmma" in n for n in bf16) and any("attn_bwd_dq_wgmma" in n for n in bf16)
    assert not any("attn_bwd_dkdv<" in n or "attn_bwd_dq<" in n for n in bf16), bf16
    f32 = kernel_names(torch.float32)
    assert not any("wgmma" in n for n in f32) and any("attn_bwd_dq<" in n for n in f32), f32
    for dh in (32, 64, 128):
        for kernel, nc in (("dkdv", 2), ("dq", 1), ("dq", 2)):
            spill = bwd_kernel_info(dh, nc, kernel)["local_bytes"]
            assert spill <= (32 if (kernel, dh) == ("dq", 128) else 0), (dh, nc, kernel, spill)
