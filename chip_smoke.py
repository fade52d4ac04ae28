#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Six paths, each driven with its kernels' launch counts set to 0 just before
and read just after (the paper pipeline once more through its CLI):

* the paper pipeline of `repro_torch` (R-MAT graph → vertex-program trace →
  partition → traffic → stacked placement search → stacked analytic
  simulator) on the Table-2 workload `amazon` at its published size (304,000
  nodes, 4,300,000 edges), on the `paper` grid's 12 configurations for it
  (bfs/sssp/pagerank × mesh2d/fbutterfly × proposed vs randomized baseline, 16
  engines); then on the same graph the windowed NoC replay (the
  `backpressure` grid's 6 configurations, pagerank × mesh2d/torus2d/torus3d ×
  proposed vs baseline, both routing arms, open loop and credit at depths
  0.5-8 and inf, the flight recorder attached) and the journaled resilience
  runner (the `faults` grid: mesh2d/torus2d × 5 fault rates, 10 units, then
  resumed from its journal); its kernel is `segment_spmm` (every ELL bucket
  of a PageRank reduce in one launch, `csrc/ell_spmm.cu`), launched by the
  traces of all three runs.  Then the same pipeline as its users run it,
  through the sweep CLI (`repro_torch.experiments.run.main`, in process):
  `--grid backpressure` and `--grid faults` (20 units, then `--resume`) on
  amazon and soc-pokec (1,600,000 nodes, 30,600,000 edges) at scale 1.0, and
  `--grid paper` at its own scale 0.01 (48 configurations, the four Table-2
  workloads), whose records must equal the reference package's committed
  numpy run (`BENCH_sweep.json`) field for field but the wall time;
* LM serving: `repro_torch.launch.serve.build_engine` on llama3.2-3b at its
  published width and depth (28 layers, d_model 3072, 24/8 heads, d_ff 8192,
  vocab 128256; random weights from a seeded generator on the card), 4 slots,
  max_seq 4096, float32 KV cache, 8 requests of 512-3072 prompt tokens and 32
  new tokens each; its kernel is `flash_attention` (every prefill layer);
* GNNs: gin-tu, gat-cora, pna and graphcast at their published widths and
  depths on the `full_graph_sm` cell (R-MAT, 2,708 nodes, 10,556 edges,
  d_in 1,433; graphcast's mesh at refinement 4), gin-tu on `molecule` (128
  graphs of 30 nodes), and gin-tu on the amazon graph above at the
  `ogb_products` feature width (100), through `models.gnn.forward` and
  `loss_fn` under `inference_mode`; its kernel is `segment_spmm` (GIN's
  neighbour sum, once a layer, at D = d_in and then 64); gin-tu on amazon
  also trains (6 AdamW steps), its gradient through the same kernel over the
  transposed ELL;
* training: `launch.train.train`, the code path of `python -m
  repro_torch.launch.train`: llama3.2-3b at its published width and depth
  (3,606,752,256 float32 params, bf16 activations, a recompute a layer) for
  20 steps at the reference's defaults (batch 8, seq 128, lr 1e-3, AdamW,
  clip 1.0), then gin-tu, gat-cora and pna at `full_graph_sm`'s widths on
  the reference launcher's graph (R-MAT, 512 nodes, 4,096 edges) for 20
  steps each, and graphcast refused; its kernels are `flash_attention` (twice
  a layer a step: forward and recompute), `flash_attention_bwd` (once a
  layer a step) and `segment_spmm` (gin-tu: 5 forward and 4 backward a step);
* recsys: dcn-v2 at its published configuration (26 tables × 1,000,000 × 16,
  cross 3 × 429², MLP 1024-1024-512: 418,569,930 float32 params from a seeded
  generator on the card) — the `RECSYS_SHAPES` cells `serve_p99` (batch 512),
  `serve_bulk` (262,144) and `retrieval_cand` (1 query, 1,000,000 candidates,
  top-100) through `models.recsys`, then `train_batch` (65,536) for 20 steps
  through `launch.train.train`, the code path of `python -m
  repro_torch.launch.train --arch dcn-v2 --batch 65536`; its kernel is
  `embedding_bag` (every forward and every training step);
* MoE serving: `build_engine` on olmoe-1b-7b at its published width and
  depth (16 layers, d_model 2048, 16/16 heads, 64 experts top-8 of width
  1024, vocab 50304; random weights, bf16 over a float32 master) with the
  LM serving path's traffic, then qwen2-moe-a2.7b at its published width (60
  experts top-4 of width 1408, a 5632-wide shared expert with its sigmoid
  gate, vocab 151936) over 4 of its 24 layers, one prompt of 2048 tokens and
  8 decode steps; experts `impl="local"` (sort, scatter, `torch.bmm`,
  combine); its kernel is `flash_attention` (every prefill layer).

Phases, one JSON line each:

  probe      the card and the toolchain
  build      `nvcc` on every source of `src/repro_torch/csrc/`, all at once
  kernels    `ell_spmm` (one bucket) against its plain PyTorch version (test
             shapes, every real ELL bucket of the full-size graph, two runs
             bit-equal); the fused `segment_spmm` reduce against the
             per-bucket route (bit-equal), the plain reader of the flat
             layout and `torch.sparse.mm`, one launch a reduce, isolated
             vertices 0; its time beside the per-bucket route's, the byte
             bound and `torch.sparse.mm` (call and CUDA-graph replay)
  engine     `run_traced` for the three algorithms against host references
  sweep      `run_sweep` with the torch backend against the numpy backend
  contention `run_sweep` with the contention pass and the flight recorder:
             the torch steppers' timelines against numpy's (open arm bit for
             bit, credit arm within 1e-9 of the peak, credit@inf bit-equal to
             open), recording on against off, proposed beating baseline on
             the mesh; launches, device time a window and busy share of a
             replay (`torch.profiler`), the two arms' wall times
  faults     `run_resilience` with the torch arm: every unit completes, parity
             within 1e-6 (0 at rate 0), a resumed run served from the journal
             and byte-identical
  gnn        the four GNN archs at published width: finite outputs and losses,
             GIN's ELL route against its scatter route, one `segment_spmm`
             launch a GIN layer and none elsewhere; gin-tu on amazon at d_in
             100: host batch and `build_ell` seconds, forward wall and device
             time by kernel, busy share, and one reduce at D = 100 and 64 beside
             its bound, `torch.sparse.mm`, the scatter route, the plain version
             and the same launch without its hub rows; then its training: the
             ELL and its transpose on the host, gradients against the scatter
             route's, 9 reduces a step, step ms, and the transposed reduce at
             D = 64 beside its bound and `torch.sparse.mm`
  cli        the sweep CLI: backpressure, faults (then resumed: byte-identical,
             no trace) and paper, each with a cold cache of its own; wall time
             and stage split a grid, one `segment_spmm` launch a PageRank
             iteration, `--check` clean on the port's EXPERIMENTS.md and
             BENCH_sweep.json, the paper records equal to the committed ones
  attention  `flash_attention` against its plain version (test shapes, f32
             and bf16, and the serve path's shapes; two runs bit-equal), its
             time and TFLOP/s at every path shape beside the operation bound
             and `scaled_dot_product_attention` (call and CUDA-graph
             replay), and the bf16 kernel's registers and shared memory;
             the forward's output and log-sum-exp against the plain
             forward's, and `flash_attention_bwd` on the kernel's forward
             against `flash_attention_bwd_ref` on the plain forward (test
             shapes, f32 and bf16, offsets, rows that see no key, the
             training and serve shapes; two runs bit-equal) and its time at
             the training and serve shapes beside its bound, the plain
             version and SDPA's backward, each of its three kernels' device
             time there, the bf16 route's kernels by name and their
             registers, spills and shared memory
  serve      the serve path, its throughput, and full-width logit checks
  train      the training path: llama3.2-3b's losses (finite, the last below
             the first), step ms of the last 10, tokens/s, peak memory, one
             step's device time by kernel (GEMMs, attention forward and
             backward, the rest) and busy share, the optimizer alone, 56 + 28
             attention launches a step; gin-tu/gat-cora/pna losses, step ms,
             9 reduces a gin-tu step; on gin-tu's training batch, one step's
             gradients through the ELL against the scatter route's and the
             transposed reduce against its plain version and the scatter
             route's gradient; graphcast refused
  embedding_bag  `embedding_bag` against its plain version (test shapes, f32
             and bf16, weighted or not; autograd gradients of tables and
             weights; dcn-v2's lookup at batch 65,536 and a weighted
             multi-hot lookup, L = 8 at batch 8,192; two runs bit-equal) and
             its time beside the byte bound and `F.embedding_bag`
  recsys     the recsys path: serve logits of the kernel route against the
             plain route, retrieval top-100 against the full scores, 20
             training steps against the same 20 through the plain route:
             table rows never looked up only decayed, looked-up rows changed
             (the same rows in both routes)
  moe        the attention kernel at olmoe's prefill shape (16 query and 16
             kv heads) against its plain version; olmoe-1b-7b and the cut
             qwen2-moe-a2.7b through the serve path: requests drained,
             attention launches, float32 and bf16 logits against the float32
             model, `moe_block` against the plain per-expert loop
             `moe_loop_ref` on one layer (float32: kept slots equal), two
             prefills bit-equal; prefill tokens/s, decode ms a step, peak
             memory, C and the dropped share of each prefill, the expert
             load skew of each layer, the device split of a prefill and of a
             decode step (router, dispatch, experts, combine, attention, the
             rest) and the decode step's byte bound with every expert read
             and with only the experts hit

Every line carries `seconds`, the time since the line before it.

then the contract lines: one `{"kernels": [...]}` object (ell_spmm,
flash_attention, flash_attention_bwd, embedding_bag), the card's name and
power limit as `nvidia-smi` prints them, and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Any failed check raises, so the script exits non-zero and prints no last
line.  Without a CUDA device it exits with code 2 at once; it never carries on
on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import statistics
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the tensor
# cores, dense bf16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12

TEST_SHAPES = [(50, 16, 8), (100, 7, 3), (30, 4, 16), (64, 32, 1)]  # (N, R, W)
TEST_DIMS = [1, 16, 64, 128, 256]
F32_TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of an fp32 sum
KERNEL_SOURCE = "src/repro_torch/csrc/ell_spmm.cu"
KERNEL_REPLACES = "src/repro/kernels/segment_spmm/kernel.py:51"

# flash attention: tests/test_kernels.py:24-29 (B, Sq, Skv, Hq, Hkv, dh), and
# the serve path's q (1, S, 24, 128), k/v (1, S, 8, 128) bf16 at these S
ATTN_TEST_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 1, 32), (2, 96, 160, 4, 4, 64),
                    (1, 200, 200, 6, 2, 128), (2, 1000, 1100, 16, 4, 64)]  # the last: ragged 128-row q tiles
ATTN_PATH_S = (512, 2048, 3072)
ATTN_TIMED_S = 2048
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:89"
# the attention backward: (B, Sq, Skv, Hq, Hkv, dh) at G = 1, 3, 3, 4, 3, every head dim,
# ragged lengths, each causal (q_offset = Skv - Sq) and not; then q_offset -40 (40
# rows see no key) and 37; timed at llama3.2-3b's training shape (launch.train's
# batch 8, seq 128) and at the serve path's S
ATTN_BWD_TEST_SHAPES = [(2, 128, 128, 4, 4, 64), (1, 96, 160, 6, 2, 32), (2, 77, 77, 24, 8, 128),
                        (1, 200, 328, 8, 2, 128), (2, 100, 90, 6, 2, 64)]
ATTN_BWD_OFFSETS = (-40, 37)
ATTN_TRAIN_SHAPE = (8, 128, 24, 8, 128)  # (B, S, Hq, Hkv, dh)
# each gradient within this share of its largest magnitude: float32 sums in
# another order; in bf16 the kernel and the plain version each round one fp32 value
BWD_REL = {"f32": 1e-5, "bf16": 1e-2}
# the forward's log-sum-exp (natural log, float32 in both dtypes: fp32 scores
# summed in another order; the bf16 kernel's exponentials are exp2 of scores
# scaled into log2 units) of each row that sees a key, as the `-m gpu` tests
# hold it; a row that sees none holds a sentinel at or below LSE_NO_KEY in both
# (its output is not compared: the plain version and the kernel average
# different masked tiles there, and the backward gives such a row nothing)
LSE_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=1e-4, atol=1e-2)}
LSE_NO_KEY = -1e29
FA_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"

# embedding bag: tests/test_kernels.py:84-86 (T, V, D, B, L); the path's
# lookup is dcn-v2's, single-hot at the train_batch cell's 65,536, and a
# weighted multi-hot lookup (DcnConfig.multi_hot) at L = 8, batch 8,192
BAG_TEST_SHAPES = [(3, 64, 128, 4, 5), (2, 32, 16, 8, 1), (1, 100, 256, 2, 7), (4, 17, 8, 3, 2)]
BAG_PATH_BATCH = 65_536
BAG_MULTI_HOT, BAG_MULTI_BATCH = 8, 8_192
BAG_SOURCE = "src/repro_torch/csrc/embedding_bag.cu"
BAG_REPLACES = "src/repro/kernels/embedding_bag/kernel.py:51"
SECTOR_BYTES = 32  # the unit in which device memory serves a gathered row

# the sweep CLI: the backpressure and faults grids as users run them (amazon
# and soc-pokec), and the reference package's committed numpy run of the
# paper grid (its own scale, 0.01, seed 0) that the port's paper records
# must equal field for field but the wall time
CLI_SCALE = 1.0
COMMITTED_BENCH = ROOT / "BENCH_sweep.json"

# windowed NoC replay: the credit arm's torch stepper against numpy's, relative
# to each timeline's peak (its contractions sum in another order; ~1e-15 seen)
NOC_CREDIT_RTOL = 1e-9

# recsys: dcn-v2 at its published configuration
RECSYS_ARCH = "dcn-v2"
RECSYS_PARAMS = 418_569_930
TRAIN_STEPS, TRAIN_LR = 20, 1e-3  # launch.train's defaults but for --steps
# the two routes' forwards are bit-equal at L = 1 (one id × 1.0); their
# backward is one code path whose `index_add_` adds with atomics in a run's
# own order, so the routes drift apart by rounding only
TRAIN_LOSS_TOL = 1e-4
DECAY_RTOL = 1e-5  # 20 steps of p − lr·wd·p in float32, three roundings a step
# The loss falls from 0.69 to about 0.12 in the 20 steps: a row looked up late,
# by well-classified examples only, gets a gradient far below AdamW's eps and
# moves by less than DECAY_RTOL — in both routes alike.  So: every row never
# looked up only decays; every row first looked up in the first half changes;
# at least this share of all looked-up rows changes; and the plain route
# changes the same rows, but for this share of them (atomic-order noise)
ROWS_CHANGED_MIN_SHARE = 0.9
ROUTES_ROW_DISAGREEMENT_MAX = 1e-4

# serve: llama3.2-3b at its published width and depth
SERVE_ARCH = "llama3.2-3b"
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 4096, 8, 32
SERVE_PROMPT = (512, 3073)  # prompt lengths drawn from [512, 3072]
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)  # float32 logits, as tests/test_models.py
# bf16 logits of 28 layers: a rounding flip in one layer's activations cascades,
# so the one-op bf16 tolerance does not apply to them; instead the kernel's route
# (and decode) must be no less accurate against the float32 model than the
# plain route is (mean abs error, within this factor)
BF16_ROUTE_FACTOR = 1.5


# GNNs: the four archs at their published widths on full_graph_sm, then gin-tu
# on the amazon graph at ogb_products' feature width (tools/gnn_full_scale.py
# runs ogb_products' own size)
GNN_ARCH = "gin-tu"
GNN_WIDE_CELL = "ogb_products"
# float32 logits of the ELL route against the scatter route: the same sums in
# another order, through 5 layers with LayerNorm
GNN_TOL = dict(rtol=1e-4, atol=1e-4)
# one neighbour sum of N(0, 1) rows against another route, in another order:
# up to 23,552 terms on amazon (sums ~150 in magnitude), over 131,072 at
# ogb_products' size
GIN_REDUCE_TOL = dict(rtol=2e-3, atol=1e-3)
GIN_KERNEL_GROUPS = {"segment_fused_ms": ("segment_fused",), "gemm_ms": ("gemm", "xmma", "cutlass")}
GNN_CUTS = [
    "weights random from a seeded generator (no trained checkpoint)",
    "graphs are seeded R-MAT with features and labels planted by GraphBatcher, not Cora/TU/ogbn-products",
    "graphcast: full_graph_sm's 2,708 grid nodes, its mesh at refinement 4 (2,562 nodes, 20,460 m2m edges) "
    "with random edges and features, as tests/test_arch_smoke.py makes them; no icosahedral geometry",
    "gin-tu at ogb_products' width (d_in 100) runs on amazon (304,000 nodes, 4,300,000 edges), the graph the "
    "other phases hold; ogb_products' own size is tools/gnn_full_scale.py",
    "gin-tu trains on amazon for 6 steps here; the 20-step training of gin-tu, gat-cora and pna is the "
    "train phase, on the reference launcher's graph (R-MAT, 512 nodes, 4,096 edges)",
    "minibatch_lg (fanout-sampled batches) is not driven on the card",
]


_LAST_LINE = [time.perf_counter()]


def say(phase: str, **fields) -> None:
    """One JSON line; `seconds` is the time since the line before it."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - _LAST_LINE[0])
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """Median time of one call of a callable, two ways, both with CUDA events.

    `call_ms`   — `calls` calls enqueued back to back between one pair of
                  events: what a caller in a loop sees, the larger of the
                  host's enqueue cost and the device's time.
    `device_ms` — the same calls captured once into a CUDA graph and replayed:
                  the device's time alone, with no host between launches.
    """

    def _median(self, run, calls: int, reps: int) -> float:
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    def call_ms(self, fn, *, calls: int = 20, reps: int = 20) -> float:
        def run():
            for _ in range(calls):
                fn()

        run()  # warm
        return self._median(run, calls, reps)

    def device_ms(self, fn, *, calls: int = 20, reps: int = 20) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return self._median(graph.replay, calls, reps)


# --------------------------------------------------------------------------- kernels


def bucket_bound_ms(x: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor | None) -> tuple[float, str]:
    """Least time for one `ell_spmm` call on these inputs: bytes (cols and wts
    read once, each gathered x row once, the output written once) over the
    memory rate, against multiply-adds on the real entries over the f32 rate."""
    n, d = x.shape
    real = cols[(cols >= 0) & (cols < n)]
    touched = int(torch.unique(real).numel())
    item = x.element_size()
    nbytes = cols.numel() * 4 + (wts.numel() * 4 if wts is not None else 0)
    nbytes += touched * d * item + cols.shape[0] * d * item
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * real.numel() * d / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def reduce_bound_ms(x: torch.Tensor, ell) -> tuple[float, str]:
    """Least time for one whole `segment_spmm` reduce on these inputs: the flat
    cols, weights and rows, the work table and the zero list read once, each
    gathered x row once, the (N, D) output written once, over the memory rate,
    against multiply-adds on the real entries over the f32 rate."""
    n, d = x.shape
    work = ell.work()
    real = work.cols[(work.cols >= 0) & (work.cols < n)]
    item = x.element_size()
    nbytes = (work.cols.numel() + work.rows.numel() + work.zero_rows.numel()) * 4 + work.items.numel() * 8
    nbytes += (work.weights.numel() * 4 if work.weights is not None else 0)
    nbytes += int(torch.unique(real).numel()) * d * item + n * d * item
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * real.numel() * d / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def per_bucket_reduce(x: torch.Tensor, ell) -> torch.Tensor:
    """The reduce as PR 13's engine ran it: a zeroed (N+1, D) buffer, one
    `ell_spmm` launch and one scatter a bucket, the sentinel row sliced off."""
    from repro_torch.kernels.segment_spmm.ops import ell_spmm

    n = x.shape[0]
    out = torch.zeros((n + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    for b in range(ell.num_buckets):
        if ell.cols[b].shape[0]:
            out[ell.rows[b].long().clamp(max=n)] = ell_spmm(x, ell.cols[b], ell.weights[b])
    return out[:n]


def phase_kernels(device: torch.device, graph, timer: Timer) -> dict:
    from repro_torch.graph.algorithms import prepare_graph
    from repro_torch.graph.structs import build_ell
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
    from repro_torch.kernels.segment_spmm.ref import ell_spmm_ref, segment_spmm_ref

    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    rng = np.random.default_rng(0)
    for n, r, w in TEST_SHAPES:
        for d in TEST_DIMS:
            x32 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
            cols = torch.from_numpy(rng.integers(0, n + 10, (r, w)).astype(np.int32)).to(device)
            wts = torch.from_numpy(rng.standard_normal((r, w)).astype(np.float32)).to(device)
            for dtype, tag, tol in ((torch.float32, "f32", F32_TOL), (torch.bfloat16, "bf16", BF16_TOL)):
                x = x32.to(dtype)
                for ww in (wts, None):
                    got = ell_spmm(x, cols, ww)
                    again = ell_spmm(x, cols, ww)
                    want = ell_spmm_ref(x, cols, ww)
                    torch.cuda.synchronize()
                    check(got.dtype == x.dtype and got.shape == (r, d), f"shape/dtype at {(n, r, w, d, tag)}")
                    check(torch.equal(got, again), f"two runs differ at {(n, r, w, d, tag)}")
                    err = float((got.float() - want.float()).abs().max())
                    max_err[tag] = max(max_err[tag], err)
                    check(
                        torch.allclose(got.float(), want.float(), **tol),
                        f"kernel vs plain version at {(n, r, w, d, tag, ww is not None)}: max abs err {err}",
                    )
                    cases += 1
    # R == 0: an empty result and no launch
    before = ell_spmm.launches
    empty = ell_spmm(x32, torch.zeros((0, 8), dtype=torch.int32, device=device), None)
    check(empty.shape == (0, x32.shape[1]) and ell_spmm.launches == before, "R == 0 must not launch")

    # every real bucket of the full-size PageRank graph, at the engine's D = 1
    pg = prepare_graph("pagerank", graph)
    ell = build_ell(pg.reversed(), device=device)
    n = graph.num_nodes
    x = torch.from_numpy(rng.random((n, 1)).astype(np.float32)).to(device)
    buckets = []
    real_err = 0.0
    for b in range(ell.num_buckets):
        cols, wts = ell.cols[b], ell.weights[b]
        if cols.shape[0] == 0:
            continue
        got, again, want = ell_spmm(x, cols, wts), ell_spmm(x, cols, wts), ell_spmm_ref(x, cols, wts)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"two runs differ on bucket W={ell.widths[b]}")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **F32_TOL), f"bucket W={ell.widths[b]}: max abs err {err}")
        real_err = max(real_err, err)
        bound, _ = bucket_bound_ms(x, cols, wts)
        buckets.append({"W": ell.widths[b], "R": int(cols.shape[0]), "ms": timer.device_ms(lambda: ell_spmm(x, cols, wts)),
                        "bound_ms": bound, "max_abs_err": err})

    # the whole reduce in one launch, against the per-bucket route (bit-equal:
    # the same lanes and order a row), the plain reader of the flat layout, and
    # at D = 16 as well; isolated vertices exactly 0
    isolated = torch.from_numpy(np.setdiff1d(np.arange(n), pg.dst)).to(device)
    fused_err = 0.0
    for d in (1, 16):
        xd = x if d == 1 else torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xt = xd.to(dtype)
            before = segment_spmm.launches
            got = segment_spmm(xt, ell)
            check(segment_spmm.launches == before + 1, "segment_spmm: one launch a reduce")
            per_bucket, want = per_bucket_reduce(xt, ell), segment_spmm_ref(xt, ell)
            torch.cuda.synchronize()
            check(torch.equal(got, per_bucket), f"fused vs per-bucket route differ at D={d}, {dtype}")
            check(bool((got[isolated] == 0).all()), "a vertex in no bucket is not 0")
            err = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), **tol), f"fused vs plain reader at D={d}: {err}")
            if dtype == torch.float32:
                fused_err = max(fused_err, err)
    before = segment_spmm.launches
    segment_spmm(x, ell)
    launches_per_reduce = segment_spmm.launches - before
    check(launches_per_reduce == 1, f"a reduce launched {launches_per_reduce} kernels")

    reduce_ms = timer.device_ms(lambda: segment_spmm(x, ell), calls=10)
    reduce_call_ms = timer.call_ms(lambda: segment_spmm(x, ell))
    per_bucket_ms = timer.device_ms(lambda: per_bucket_reduce(x, ell), calls=5)
    per_bucket_call_ms = timer.call_ms(lambda: per_bucket_reduce(x, ell), calls=5)
    reduce_plain_ms = timer.call_ms(lambda: segment_spmm_ref(x, ell), calls=2, reps=3)
    work = ell.work()
    real_entries = int(((work.cols >= 0) & (work.cols < n)).sum())
    bound_ms, bound_by = reduce_bound_ms(x, ell)
    per_bucket_bound_ms = sum(bk["bound_ms"] for bk in buckets)

    # yardstick: one library call computing the same function (used nowhere in the port)
    idx = torch.from_numpy(np.stack([pg.dst, pg.src]).astype(np.int64)).to(device)
    val = torch.from_numpy(pg.weight.astype(np.float32)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a_csr = torch.sparse_coo_tensor(idx, val, (n, n)).coalesce().to_sparse_csr()
    lib = torch.sparse.mm(a_csr, x)
    whole = segment_spmm(x, ell)
    torch.cuda.synchronize()
    lib_err = float((whole - lib).abs().max())
    check(torch.allclose(whole, lib, **F32_TOL), f"fused reduce vs torch.sparse.mm: {lib_err}")
    library_ms = timer.call_ms(lambda: torch.sparse.mm(a_csr, x))
    library_device_ms = timer.device_ms(lambda: torch.sparse.mm(a_csr, x))

    out = {
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL, "bit_equal_two_runs": True,
        "graph": {"nodes": n, "edges": graph.num_edges, "ell_fill": ell.fill_fraction(),
                  "real_entries": real_entries, "D": 1, "work_items": int(work.items.shape[0]),
                  "vertices_in_no_bucket": int(work.zero_rows.numel())},
        "buckets": buckets, "real_bucket_max_abs_err": real_err,
        "fused_equals_per_bucket_route": True, "fused_max_abs_err_vs_plain": fused_err,
        "launches_per_reduce": launches_per_reduce,
        "kernel_ms": reduce_ms, "kernel_call_ms": reduce_call_ms, "per_bucket_reduce_ms": per_bucket_ms,
        "per_bucket_reduce_call_ms": per_bucket_call_ms, "ref_ms": reduce_plain_ms,
        "library_ms": library_ms, "library_device_ms": library_device_ms, "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "per_bucket_bound_ms": per_bucket_bound_ms,
        "timing": "warm medians with CUDA events. kernel_ms: one whole segment_spmm reduce (output "
                  "allocation and the one fused launch) replayed from a CUDA graph (device time alone); "
                  "per_bucket_reduce_ms: PR 13's route (zeroed buffer, 12 ell_spmm launches, 12 scatters, "
                  "slice), the same way; library_device_ms: torch.sparse.mm (CSR) the same way; *_call_ms, "
                  "ref_ms, library_ms: calls enqueued from Python (host enqueue cost included); buckets[]: "
                  "each bucket's ell_spmm alone, its cols/wts warm in the L2. bound_ms: the whole reduce's "
                  "inputs read once; per_bucket_bound_ms: the sum of the buckets' bounds (PR 13's bound)",
    }
    say("kernels", **out)
    return out


# --------------------------------------------------------------------------- engine


def phase_engine(device: torch.device, graph, small_graph) -> dict:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.vertex_program import run_traced
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    out: dict = {}

    def traced(name, g, **kw):
        """(trace, seconds of the iteration loop, seconds of set-up).  Two
        iterations run first and are thrown away, so that the timed loop pays
        no first-use cost (CUDA loads an operator's kernels at its first call)."""
        t: dict = {}
        prepared, program = alg.prepare_graph(name, g), alg.ALGORITHMS[name]()
        run_traced(prepared, program, max_iterations=2, device=device, **kw)
        t["launches_before"] = segment_spmm.launches
        tr = run_traced(prepared, program, max_iterations=40 if name == "pagerank" else 200,
                        device=device, timings=t, **kw)
        traced.launches = segment_spmm.launches - t["launches_before"]
        return tr, t["loop_s"], t["prepare_s"]

    # BFS: the pure-Python frontier reference at a twentieth of the size, scipy at full size
    tr, _, _ = traced("bfs", small_graph)
    check(np.array_equal(tr.props, alg.reference_bfs(small_graph, 0)), "bfs vs reference_bfs (small)")
    tr, secs, prep = traced("bfs", graph)
    adj = csr_matrix((np.ones(graph.num_edges), (graph.src, graph.dst)),
                     shape=(graph.num_nodes, graph.num_nodes))
    want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=0)
    check(np.array_equal(tr.props.astype(np.float64), want), "bfs vs scipy shortest_path (full size)")
    out["bfs"] = {"iterations": tr.num_iterations, "s_per_iteration": secs / max(tr.num_iterations, 1),
                  "prepare_s": prep, "reached": int(np.isfinite(tr.props).sum()), "exact": True}

    # SSSP: Dijkstra in float64 against min over float32 path sums
    tr, secs, prep = traced("sssp", graph)
    want = alg.reference_sssp(alg.prepare_graph("sssp", graph), 0)
    check(np.array_equal(np.isfinite(tr.props), np.isfinite(want)), "sssp reachability")
    fin = np.isfinite(want)
    rel = float(np.max(np.abs(tr.props[fin] - want[fin]) / np.maximum(want[fin], 1.0)))
    check(rel <= 1e-5, f"sssp vs Dijkstra: max relative error {rel}")
    out["sssp"] = {"iterations": tr.num_iterations, "s_per_iteration": secs / max(tr.num_iterations, 1),
                   "prepare_s": prep, "max_rel_err_vs_float64_dijkstra": rel}

    # PageRank: the kernel's sum against index_add_ and against the host reference
    tr_ell, secs_ell, prep_ell = traced("pagerank", graph, reduce_impl="ell")
    launches = traced.launches  # of the timed run alone
    check(launches == tr_ell.num_iterations,
          f"pagerank launched segment_spmm {launches} times in {tr_ell.num_iterations} iterations, want one each")
    tr_sc, secs_sc, prep_sc = traced("pagerank", graph, reduce_impl="scatter")
    ref = alg.reference_pagerank(alg.prepare_graph("pagerank", graph))
    rel = float(np.max(np.abs(tr_ell.props - tr_sc.props) / np.abs(tr_sc.props)))
    check(rel <= 2e-3, f"pagerank ell vs scatter: max relative error {rel}")
    l1 = float(np.abs(tr_ell.props.astype(np.float64) - ref).sum())
    check(np.allclose(tr_ell.props, ref, atol=1e-4) and l1 <= 1e-3, f"pagerank vs reference: L1 {l1}")
    check(abs(float(tr_ell.props.sum()) - float(tr_sc.props.sum())) < 1e-3, "pagerank mass")
    check(tr_ell.num_iterations == tr_sc.num_iterations, "pagerank: ell and scatter iteration counts differ")
    check(bool(np.array_equal(tr_ell.edge_activity, tr_sc.edge_activity)), "pagerank: edge_activity differs")
    out["pagerank"] = {
        "iterations_ell": tr_ell.num_iterations, "iterations_scatter": tr_sc.num_iterations,
        "s_per_iteration_ell": secs_ell / tr_ell.num_iterations,
        "s_per_iteration_scatter": secs_sc / tr_sc.num_iterations,
        "prepare_s_ell": prep_ell, "prepare_s_scatter": prep_sc,
        "segment_spmm_launches": launches, "max_rel_err_ell_vs_scatter": rel, "l1_vs_reference": l1,
        "edge_activity_equal": bool(np.array_equal(tr_ell.edge_activity, tr_sc.edge_activity)),
    }
    say("engine", **out)
    return out


# --------------------------------------------------------------------------- sweep


def phase_sweep(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    from repro_torch.experiments.batched import simulate_batch
    from repro_torch.experiments.placement_batch import place_batch
    from repro_torch.experiments.sweep import figure_comparisons, run_sweep
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    segment_spmm.launches = ell_spmm.launches = 0  # the main path's own count starts here
    torch.cuda.synchronize()
    res = run_sweep(grid, backend="torch", device=device, measure_serial=True,
                    graphs={"amazon": graph}, keep_artifacts=True)
    torch.cuda.synchronize()
    launches = segment_spmm.launches
    check(launches > 0, "run_sweep launched segment_spmm no time")
    check(ell_spmm.launches == 0, "run_sweep launched the one-bucket kernel")
    configs = grid.expand()
    check(len(res.records) == len(configs), "a record for every configuration")
    for r in res.records:
        vals = dataclasses.asdict(r.result)
        check(all(v is None or np.isfinite(v) for v in vals.values()), f"non-finite result in {r.config.key}")
        check(r.result.total_bytes > 0 and r.num_edges == graph.num_edges, f"empty traffic in {r.config.key}")
    comps = figure_comparisons(res.records)
    check(len(comps) == len(configs) // 2 and all(np.isfinite(c["speedup"]) for c in comps),
          "a finite proposed-vs-baseline comparison for every cell")
    check(all(c["speedup"] > 1 for c in comps if c["topology"] == "mesh2d"),
          "the proposed scheme must beat the randomized baseline on the mesh")

    art = res.artifacts
    kw = dict(methods=[c.placement for c in configs], seeds=[c.seed for c in configs])
    p_torch, _ = place_batch(art["traffics"], art["partitions"], art["topologies"],
                             backend="torch", device=device, **kw)
    p_numpy, _ = place_batch(art["traffics"], art["partitions"], art["topologies"], backend="numpy", **kw)
    sites_equal = all(np.array_equal(a.site, b.site) for a, b in zip(p_torch, p_numpy))
    check(sites_equal, "placements of the torch backend differ from the numpy backend's")
    s_numpy = simulate_batch(art["traffics"], art["placements"], num_iterations=art["num_iterations"],
                             backend="numpy")
    worst = 0.0
    for rec, b in zip(res.records, s_numpy):
        for k, v in dataclasses.asdict(rec.result).items():
            w = getattr(b, k)
            if v is None or w is None:
                check(v is w, f"{k} set in one backend only")
                continue
            worst = max(worst, abs(v - w) / max(abs(w), 1e-300))
    check(worst <= 1e-9, f"simulate_batch torch vs numpy: max relative difference {worst}")
    out = {
        "configs": len(configs), "scale": grid.scale, "backend": res.backend, "cuts": [],
        "placement_sites_equal_numpy": sites_equal, "simulate_max_rel_diff_vs_numpy": worst,
        "min_speedup": min(c["speedup"] for c in comps), "max_speedup": max(c["speedup"] for c in comps),
        "timings_s": res.timings, "placement_stats": res.placement_stats,
        "segment_spmm_launches": launches, "card": smi,
    }
    say("sweep", **out)
    return out, launches


# --------------------------------------------------------------------------- windowed NoC replay


def device_profile(fn) -> dict:
    """Kernel launches, memory copies and device time of one call, read from
    `torch.profiler`: `device_busy_ms` is the union of the device's intervals,
    `kernel_ms` the sum of the kernels' durations, `profiled_wall_ms` the host
    clock around that same call (profiler overhead included) and
    `busy_share` their ratio; `result` is what `fn` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.lower().startswith(("memcpy", "memset"))]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernel_launches": len(kernels), "copies": len(dev) - len(kernels),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "device_busy_ms": busy / 1e3, "profiled_wall_ms": wall,
            "busy_share": busy / 1e3 / wall, "result": result}


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of one call that ends in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _without_clock(d: dict) -> dict:
    """A `SweepResult.to_dict()` without what the wall clock and the cache's
    hit/miss counts set: what recording must leave unchanged."""
    out = {k: v for k, v in d.items() if k not in ("timings", "memory", "cache_stats")}
    for rows in ("records", "comparisons"):
        out[rows] = [{k: v for k, v in r.items() if k != "elapsed_us"} for r in d[rows]]
    out["placement_stats"] = {k: v for k, v in d["placement_stats"].items() if not k.endswith("_s")}
    if d["contention"] is not None:
        out["contention"] = {k: v for k, v in d["contention"].items() if k != "timings"}
    return out


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got − want| relative to the timeline's peak (a backlog that
    drains to ~0 keeps a residue of the order of its peak's last bit)."""
    return float(np.max(np.abs(got - want), initial=0.0) / max(1.0, float(np.max(np.abs(want), initial=0.0))))


def phase_contention(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    import tempfile

    from repro_torch.experiments.cache import SweepCache
    from repro_torch.experiments.sweep import run_sweep
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
    from repro_torch.nocsim import NocSimParams, build_credit_program, contended_batch, run_credit
    from repro_torch.nocsim.batch import (PARITY_RTOL, contention_sweep_payload, open_step, run_windows,
                                          stacked_open_program)
    from repro_torch.nocsim.model import build_schedule
    from repro_torch.nocsim.routes import ROUTING_POLICIES
    from repro_torch.obs import FlightRecorder

    with tempfile.TemporaryDirectory() as tmp:
        cache = SweepCache(tmp, device=device)
        rec = FlightRecorder()
        segment_spmm.launches = ell_spmm.launches = 0  # the path's own count starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_sweep(grid, backend="torch", device=device, measure_serial=False, cache=cache,
                        graphs={"amazon": graph}, recorder=rec, keep_artifacts=True)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = segment_spmm.launches
        check(launches > 0, "the contention sweep launched segment_spmm no time")
        check(ell_spmm.launches == 0, "the contention sweep launched the one-bucket kernel")
        # the same sweep with the recorder off (traces and traffic from the cache)
        off = run_sweep(grid, backend="torch", device=device, measure_serial=False, cache=cache,
                        graphs={"amazon": graph})
    check(_without_clock(res.to_dict()) == _without_clock(off.to_dict()),
          "the sweep's payload differs with the recorder on")
    cont = res.contention
    configs = grid.expand()
    n_arms = len(ROUTING_POLICIES) * (1 + len(grid.buffer_depths))
    check(len(cont["records"]) == len(configs) * n_arms, "a contention record for every config and arm")
    for r in cont["records"]:
        check(all(v is None or np.isfinite(v) for v in r.values() if isinstance(v, float)),
              f"non-finite contention record {r['key']} {r['routing']} {r['flow_control']}")
    check(cont["backends"] == ["numpy", "torch"], "both arms ran")
    check(cont["backend_parity_max_rel"] <= NOC_CREDIT_RTOL, f"numpy↔torch parity {cont['backend_parity_max_rel']}")
    check(cont["credit_inf_numpy_max_abs"] == 0.0, "numpy credit@inf differs from the open arm")
    check(cont["credit_inf_torch_max_rel"] == 0.0, "torch credit@inf differs from the open arm")

    # proposed vs baseline, contended T_network, on the mesh: every routing arm, open loop
    def t_net(routing, flow_control, depth, scheme):
        (r,) = [r for r in cont["records"] if r["topology"] == "mesh2d" and r["routing"] == routing
                and r["flow_control"] == flow_control and r["buffer_depth"] == depth
                and (r["partitioner"], r["placement"]) == scheme]
        return r["t_network_contended_s"]

    (prop, base) = grid.schemes()
    wins = {f"{routing}/{fc}" + ("" if d is None else f"@{d:g}"):
            t_net(routing, fc, d, base) / t_net(routing, fc, d, prop)
            for routing in ROUTING_POLICIES
            for fc, d in [("open", None)] + [("credit", d) for d in grid.buffer_depths]}
    check(all(wins[f"{routing}/open"] > 1.0 for routing in ROUTING_POLICIES),
          f"the proposed scheme does not beat the baseline on the mesh: {wins}")

    # the steppers state by state, on the sweep's own traffic and placements
    art = res.artifacts
    w = NocSimParams().windows
    worst_credit, open_equal, inf_equal, chunks_equal = 0.0, True, True, True
    replay = {}
    for routing in ROUTING_POLICIES:
        params = NocSimParams(routing=routing)
        scheds = [build_schedule(t, p, noc_params=params) for t, p in zip(art["traffics"], art["placements"])]
        inj = stacked_open_program(scheds, w)
        (s_np, b_np), _ = run_windows(open_step("numpy"), (inj,), None)
        (s_t, b_t), _ = run_windows(open_step("torch"), (torch.from_numpy(inj).to(device),), None)
        s_t, b_t = s_t.cpu().numpy(), b_t.cpu().numpy()
        open_equal &= bool(np.array_equal(s_t, s_np) and np.array_equal(b_t, b_np))
        for chunk in (1, w - 1, w):  # the carry stays on the card between chunks
            (s_c, b_c), _ = run_windows(open_step("torch"), (torch.from_numpy(inj).to(device),), None,
                                        window_chunk=chunk)
            chunks_equal &= bool(np.array_equal(s_c.cpu().numpy(), s_t) and np.array_equal(b_c.cpu().numpy(), b_t))
        for depth in tuple(grid.buffer_depths) + (float("inf"),):
            prog = build_credit_program(scheds, NocSimParams(routing=routing, flow_control="credit",
                                                             buffer_depth=depth))
            tl_t, carry_t = run_credit(prog, backend="torch", device=device)
            if depth == float("inf"):
                inf_equal &= bool(np.array_equal(tl_t.serviced, s_t) and np.array_equal(tl_t.eff_backlog, b_t))
                continue
            tl_np, carry_np = run_credit(prog, backend="numpy")
            if depth == 1.0:
                for chunk in (1, w - 1, w):
                    tl_c, _ = run_credit(prog, backend="torch", device=device, window_chunk=chunk)
                    chunks_equal &= all(np.array_equal(getattr(tl_c, f), getattr(tl_t, f)) for f in
                                        ("serviced", "eff_backlog", "buf", "src", "admitted", "arrivals"))
            for f in ("serviced", "eff_backlog", "buf", "src", "admitted", "arrivals"):
                worst_credit = max(worst_credit, _rel(getattr(tl_t, f), getattr(tl_np, f)))
            worst_credit = max(worst_credit, *(_rel(a, b) for a, b in zip(carry_t, carry_np)))
        if routing == "dor":
            replay["configs"], replay["links"] = inj.shape[1], inj.shape[2]
            replay["flows"] = prog.offered.shape[2]
            replay["pairs"] = int(prog.pair_c.size)
            replay["incidence_mb"] = prog.inc.nbytes / 1e6
            cred = NocSimParams(flow_control="credit", buffer_depth=1.0)
            for arm, p in (("open", params), ("credit_d1", cred)):
                call = lambda p=p: contended_batch(art["traffics"], art["placements"], noc_params=p,  # noqa: E731
                                                   backend="torch", schedules=scheds, device=device)
                call()  # warm
                prof = device_profile(call)
                del prof["result"]
                ms = wall_ms(call)
                replay[arm] = {**prof, "wall_ms": ms, "numpy_wall_ms": wall_ms(
                    lambda p=p: contended_batch(art["traffics"], art["placements"], noc_params=p,
                                                backend="numpy", schedules=scheds), reps=1),
                    "launches_per_window": prof["kernel_launches"] / w,
                    "device_ms_per_window": prof["kernel_ms"] / w}
    check(open_equal, "open arm: torch timelines differ from numpy's")
    check(inf_equal, "torch credit@inf differs from the torch open arm")
    check(chunks_equal, "torch arm: window chunks 1, W-1, W differ from the unchunked replay")
    check(worst_credit <= NOC_CREDIT_RTOL, f"credit arm: torch vs numpy {worst_credit} (relative to the peak)")

    # the device over the whole pass: the payload again under the profiler,
    # every share taken against that same call's own clocks
    pass_prof = device_profile(lambda: contention_sweep_payload(
        configs, art["traffics"], art["placements"], num_iterations=art["num_iterations"],
        buffer_depths=grid.buffer_depths, device=device))
    prof_torch_s = sum(v for k, v in pass_prof.pop("result")["timings"].items() if k.endswith("_torch_s"))
    t = cont["timings"]
    numpy_s = sum(v for k, v in t.items() if k.endswith("_numpy_s"))
    torch_s = sum(v for k, v in t.items() if k.endswith("_torch_s"))
    out = {
        "configs": len(configs), "scale": grid.scale, "routing_arms": list(ROUTING_POLICIES),
        "buffer_depths": list(grid.buffer_depths), "records": len(cont["records"]), "cuts": [],
        "open_torch_equals_numpy_bitwise": open_equal, "credit_max_rel_vs_numpy": worst_credit,
        "credit_tolerance": NOC_CREDIT_RTOL, "credit_inf_equals_open_torch_bitwise": inf_equal,
        "torch_chunks_1_Wm1_W_bitwise": chunks_equal,
        "payload_parity_max_rel": cont["backend_parity_max_rel"], "parity_rtol": PARITY_RTOL,
        "credit_inf_numpy_max_abs": cont["credit_inf_numpy_max_abs"],
        "credit_inf_torch_max_rel": cont["credit_inf_torch_max_rel"],
        "recorder_on_equals_off": True, "mesh_win_baseline_over_proposed": wins,
        "numpy_arm_s": numpy_s, "torch_arm_s": torch_s, "arm_timings_s": t,
        "contention_s": res.timings["contention_s"], "sweep_s": sweep_s, "sweep_timings_s": res.timings,
        "replay": replay,
        "pass_profile": {**pass_prof, "torch_arm_s": prof_torch_s,
                         "busy_share_of_torch_arm": pass_prof["device_busy_ms"] / 1e3 / prof_torch_s},
        "recorder": rec.summary(), "segment_spmm_launches": launches, "card": smi,
        "timing": "numpy_arm_s / torch_arm_s: the sums of contention_sweep_payload's per-arm host-clock "
                  "timings (14 replays each); replay.*: one contended_batch of the 6 configs on prebuilt "
                  "schedules, torch.profiler for launches and device time, busy_share = device_busy_ms / "
                  "profiled_wall_ms of that same profiled call; wall_ms: the host clock around an "
                  "unprofiled synchronised call (median of 3); pass_profile: the whole payload again under "
                  "torch.profiler, busy_share over that call's own host clock and busy_share_of_torch_arm "
                  "over the torch arm's time inside that same call",
    }
    say("contention", **out)
    return out, launches


def phase_faults(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    import os
    import tempfile

    from repro_torch.experiments.cache import SweepCache
    from repro_torch.experiments.journal import SweepJournal
    from repro_torch.experiments.resilience import run_resilience, unit_ids
    from repro_torch.faults.degraded import PARITY_RTOL
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    with tempfile.TemporaryDirectory() as tmp:
        cache = SweepCache(os.path.join(tmp, "cache"), device=device)
        path = os.path.join(tmp, "faults.json")
        segment_spmm.launches = ell_spmm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_resilience(grid, cache=cache, backend="torch", device=device, graphs={"amazon": graph},
                             journal=SweepJournal(path, grid.name, resume=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segment_spmm.launches
        check(launches > 0, "the faults runner launched segment_spmm no time")
        check(ell_spmm.launches == 0, "the faults runner launched the one-bucket kernel")
        t0 = time.perf_counter()
        again = run_resilience(grid, cache=cache, backend="torch", device=device, graphs={"amazon": graph},
                               journal=SweepJournal(path, grid.name, resume=True))
        resume_s = time.perf_counter() - t0
    uids = unit_ids(grid)
    check(len(res.records) == len(uids) and res.quarantined == {},
          f"{len(res.records)} of {len(uids)} units completed, quarantined: {sorted(res.quarantined)}")
    check(res.backend == "numpy+torch", f"backend {res.backend}")
    check(res.backend_parity_max_rel <= PARITY_RTOL, f"numpy↔torch parity {res.backend_parity_max_rel}")
    for r in res.records:
        for scheme in ("proposed", "baseline"):
            check(all(np.isfinite(v) for v in r[scheme].values() if isinstance(v, float)),
                  f"non-finite record {r['unit_id']}")
        if r["fault_rate"] == 0.0:
            check(r["backend_parity_rel"] == 0.0, f"open arm at rate 0 not bit-equal: {r['unit_id']}")
    check(all(row["batch_parity"] for row in res.repair), "repair_batch differs from the serial repair")
    check(json.dumps(again.to_dict(), sort_keys=True) == json.dumps(res.to_dict(), sort_keys=True),
          "the resumed run's payload differs")
    check(segment_spmm.launches == launches, "the resumed run traced again")
    out = {
        "units": len(res.records), "quarantined": len(res.quarantined), "scale": grid.scale,
        "topologies": list(grid.topologies), "fault_rates": list(grid.fault_rates), "cuts": [],
        "backend": res.backend, "parity_max_rel": res.backend_parity_max_rel, "parity_rtol": PARITY_RTOL,
        "parity_rel_by_unit": {r["unit_id"]: r["backend_parity_rel"] for r in res.records},
        "win_by_unit": {r["unit_id"]: r["win"] for r in res.records},
        "dead_links_by_unit": {r["unit_id"]: r["num_dead_links"] for r in res.records},
        "repair_rows": len(res.repair), "repair_batch_parity": True,
        "resume_byte_identical": True, "resume_s": resume_s, "wall_s": wall,
        "cache_stats": res.cache_stats, "segment_spmm_launches": launches, "card": smi,
        "timing": "wall_s: host clock around run_resilience (every unit on the numpy reference and the "
                  "torch arm, the repair ledger of the fault-free units, one trace); resume_s: the same call "
                  "served from the journal",
    }
    say("faults", **out)
    return out, launches


# --------------------------------------------------------------------------- GNNs


def graphcast_batch(n_grid: int, cfg, seed: int) -> dict:
    """GraphCast's batch at `n_grid` grid nodes: grid features, the planned
    multimesh's node count, random g2m/m2m/m2g edges and edge features, drawn
    from a seeded numpy generator as `tests/test_arch_smoke.py` draws them."""
    from repro_torch.models.gnn import graphcast_mesh_plan

    rng = np.random.default_rng(seed)
    plan = graphcast_mesh_plan(n_grid, cfg.mesh_refinement)
    m = plan["n_mesh"]
    b = {"x": rng.standard_normal((n_grid, cfg.d_in)).astype(np.float32),
         "mesh_x": rng.standard_normal((m, 3)).astype(np.float32),
         "labels": rng.standard_normal((n_grid, cfg.d_out)).astype(np.float32),
         "node_mask": np.ones(n_grid, bool)}
    for pre, cnt, ns, nd in (("g2m", plan["e_g2m"], n_grid, m), ("m2m", plan["e_m2m"], m, m),
                             ("m2g", plan["e_m2g"], m, n_grid)):
        b[f"{pre}_src"] = rng.integers(0, ns, cnt).astype(np.int32)
        b[f"{pre}_dst"] = rng.integers(0, nd, cnt).astype(np.int32)
        b[f"{pre}_feat"] = rng.standard_normal((cnt, 4)).astype(np.float32)
        b[f"{pre}_mask"] = np.ones(cnt, bool)
    return b


def gin_reduce_bound_ms(x: torch.Tensor, ell) -> float:
    """Least time for one GIN neighbour sum on these inputs: the rows of x that
    some edge reads, the real cols (one int32 an edge) and the (N, D) output,
    each once, over the memory rate (it is bound by bytes: one multiply-add
    an edge and feature)."""
    n, d = x.shape
    cols = ell.work().cols
    real = cols[(cols >= 0) & (cols < n)]
    nbytes = int(torch.unique(real).numel()) * d * 4 + real.numel() * 4 + n * d * 4
    return nbytes / H100_BYTES_PER_S * 1e3


def without_hub_items(ell):
    """`ell` with the hub items (rows of width ≥ ELL_HUB_WIDTH) left out of its
    work table: the fused launch then skips their rows (timing only)."""
    from repro_torch.graph.structs import ELL_HUB_WIDTH, EllWork

    w = ell.work()
    keep = w.items[:, 2] < ELL_HUB_WIDTH
    return dataclasses.replace(ell, _work=EllWork(w.rows, w.cols, w.weights, w.items[keep], w.zero_rows))


def gin_at_scale(device: torch.device, graph, timer: Timer, *, seed: int, full_scatter: bool) -> tuple[dict, int]:
    """gin-tu at its published width (5 layers of 64, 16 classes) with the
    `ogb_products` feature width (100) on `graph`, through `models.gnn`'s
    entry points: the host's batch and ELL, a forward on the ELL route (wall,
    device time by kernel, busy share), checked against the scatter route
    (the whole forward when `full_scatter`, else one layer's sum at each
    width: it materialises E × D messages) and the plain version; then one
    reduce at D = 100 and D = 64 timed beside its bound, `torch.sparse.mm`,
    the scatter route's sum, the plain version and the same launch without
    the hub items.  Returns the numbers and the `segment_spmm` launches of
    the forwards."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.graph.structs import ELL_HUB_WIDTH
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
    from repro_torch.models import gnn

    cfg = get_arch(GNN_ARCH).model_config(GNN_WIDE_CELL)
    scatter = dataclasses.replace(cfg, reduce_impl="scatter")
    n = graph.num_nodes
    t0 = time.perf_counter()
    host = GraphBatcher(graph, d_feat=cfg.d_in, n_classes=cfg.d_out, seed=seed).full_batch()
    batch_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = gnn.batch_ell(host, device=device)
    work = ell.work()
    torch.cuda.synchronize()
    build_ell_s = time.perf_counter() - t0
    batch = to_device(host, device)
    batch["ell"] = ell
    params = gnn.init_params(cfg, seed, device=device)

    before = segment_spmm.launches
    with torch.inference_mode():
        out = gnn.forward(params, batch, cfg)
        loss = float(gnn.loss_fn(params, batch, cfg))
        torch.cuda.synchronize()
        check(segment_spmm.launches - before == 2 * cfg.n_layers, "a GIN forward: one launch a layer")
        check(out.shape == (n, cfg.d_out) and bool(torch.isfinite(out).all()) and np.isfinite(loss),
              "gin on the large graph: finite logits of the right shape")
        forward_wall_ms = wall_ms(lambda: gnn.forward(params, batch, cfg))
        prof = profile_window(lambda: gnn.forward(params, batch, cfg), groups=GIN_KERNEL_GROUPS)
        prof["other_ms"] = prof["device_ms"] - prof["segment_fused_ms"] - prof["gemm_ms"]
        err = scatter_wall_ms = None
        if full_scatter:
            other = gnn.forward(params, batch, scatter)
            torch.cuda.synchronize()
            err = float((out - other).abs().max())
            check(torch.allclose(out, other, **GNN_TOL), f"gin on the large graph: ell vs scatter {err}")
            del other
            scatter_wall_ms = wall_ms(lambda: gnn.forward(params, batch, scatter))
    launches = segment_spmm.launches - before

    idx = torch.from_numpy(np.stack([graph.dst, graph.src]).astype(np.int64)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a_csr = torch.sparse_coo_tensor(idx, torch.ones(graph.num_edges, device=device), (n, n)).coalesce()
        a_csr = a_csr.to_sparse_csr()
    del idx
    no_hub = without_hub_items(ell)
    rng = np.random.default_rng(seed)
    reduces = {}
    with torch.inference_mode():
        for d in (cfg.d_in, cfg.d_hidden):
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
            hb = {"x": x, "src": batch["src"], "dst": batch["dst"], "edge_mask": batch["edge_mask"]}
            got, again = segment_spmm(x, ell), segment_spmm(x, ell)
            lib = torch.sparse.mm(a_csr, x)
            torch.cuda.synchronize()
            r = {"D": d, "bit_equal_two_runs": bool(torch.equal(got, again)),
                 "max_abs_err_vs_library": float((got - lib).abs().max())}
            check(r["bit_equal_two_runs"], f"two runs of the reduce differ at D={d}")
            check(torch.allclose(got, lib, **GIN_REDUCE_TOL), f"reduce vs torch.sparse.mm at D={d}")
            del lib
            want = segment_spmm_ref(x, ell)
            r["max_abs_err_vs_plain"] = float((got - want).abs().max())
            check(torch.allclose(got, want, **GIN_REDUCE_TOL), f"reduce vs its plain version at D={d}")
            del want
            sc = gnn.gin_sum(x, hb, scatter)
            r["max_abs_err_vs_scatter"] = float((got - sc).abs().max())
            check(torch.allclose(got, sc, **GIN_REDUCE_TOL), f"reduce vs the scatter route at D={d}")
            del sc, got, again
            torch.cuda.empty_cache()
            r["ms"] = timer.device_ms(lambda: segment_spmm(x, ell), calls=10)
            r["call_ms"] = timer.call_ms(lambda: segment_spmm(x, ell), calls=10)
            r["no_hub_ms"] = timer.device_ms(lambda: segment_spmm(x, no_hub), calls=10)
            r["bound_ms"], r["bound_by"] = gin_reduce_bound_ms(x, ell), "bytes"
            r["library_ms"] = timer.call_ms(lambda: torch.sparse.mm(a_csr, x), calls=10)
            r["library_device_ms"] = timer.device_ms(lambda: torch.sparse.mm(a_csr, x), calls=10)
            r["scatter_ms"] = timer.call_ms(lambda: gnn.gin_sum(x, hb, scatter), calls=2, reps=5)
            torch.cuda.empty_cache()
            r["plain_ms"] = timer.call_ms(lambda: segment_spmm_ref(x, ell), calls=1, reps=3)
            torch.cuda.empty_cache()
            reduces[f"D{d}"] = r
    training, train_launches = gin_training_at_scale(device, graph, host, batch, params, cfg, timer, seed=seed)
    launches += train_launches
    hub = work.items[:, 2] >= ELL_HUB_WIDTH
    out = {
        "arch": GNN_ARCH, "cell_widths": GNN_WIDE_CELL, "params": cfg.num_params, "nodes": n,
        "edges": graph.num_edges, "d_in": cfg.d_in, "loss": loss,
        "batch_host_s": batch_host_s, "build_ell_host_s": build_ell_s,
        "ell": {"work_items": int(work.items.shape[0]), "hub_items": int(hub.sum()),
                "max_width": int(work.items[:, 2].max()), "fill": ell.fill_fraction(),
                "vertices_in_no_bucket": int(work.zero_rows.numel())},
        "forward_wall_ms": forward_wall_ms, "forward_profile": prof,
        "scatter_forward_wall_ms": scatter_wall_ms, "ell_vs_scatter_max_abs_err": err,
        "reduce": reduces, "train": training,
    }
    return out, launches


def gin_grads_vs_scatter(params, batch: dict, cfg, where: str) -> tuple[float, int]:
    """One step's gradients of every leaf on the ELL route (the forward
    reduce and its transpose through the fused kernel) against the scatter
    route's (`index_add_` and its autograd) on the same weights and batch,
    within GNN_TOL.  Returns the largest difference and the step's
    `segment_spmm` launches (checked: 5 forward, 4 backward)."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.models import gnn
    from repro_torch.train.pytree import tree_leaves

    scatter = dataclasses.replace(cfg, reduce_impl="scatter")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    before = segment_spmm.launches
    got = torch.autograd.grad(gnn.loss_fn(params, batch, cfg), leaves)
    torch.cuda.synchronize()
    launches = segment_spmm.launches - before
    check(launches == 2 * cfg.n_layers - 1, f"gin training step on {where}: {launches} reduces, want 5 + 4")
    want = torch.autograd.grad(gnn.loss_fn(params, batch, scatter), leaves)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(all(torch.allclose(a, b, **GNN_TOL) for a, b in zip(got, want)),
          f"gin gradients on {where}, ell vs scatter: {err}")
    for p in leaves:
        p.requires_grad_(False)
    return err, launches


def gin_training_held(device: torch.device, seed: int) -> dict:
    """gin-tu on the batch `launch.train` trains it on (its own `_gnn_setup`:
    R-MAT 512/4,096, full_graph_sm widths, the ELL and its transpose):
    one step's gradients on the ELL route against the scatter route's, and
    the transposed reduce at D = d_hidden against its plain version and the
    scatter route's reduce gradient (autograd of `index_add_` over the same
    edges), on N(0, 1) rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
    from repro_torch.launch.train import _gnn_setup
    from repro_torch.models import gnn

    cfg, params, _, batches = _gnn_setup(get_arch(GNN_ARCH), smoke=False, seed=seed, device=device)
    batch = next(batches)
    check(batch["ell"].transpose is not None, "launch.train's gin-tu batch carries no transposed ELL")
    grad_err, launches = gin_grads_vs_scatter(params, batch, cfg, "launch.train's graph")

    n = batch["x"].shape[0]
    g = torch.from_numpy(np.random.default_rng(seed + 5).standard_normal((n, cfg.d_hidden)).astype(np.float32))
    g = g.to(device)
    h = torch.zeros_like(g, requires_grad=True)
    scatter = dataclasses.replace(cfg, reduce_impl="scatter")
    by_scatter = torch.autograd.grad(gnn.gin_sum(h, batch, scatter), h, g)[0]
    with torch.inference_mode():
        red = segment_spmm(g, batch["ell"].transpose)
        plain = segment_spmm_ref(g, batch["ell"].transpose)
    torch.cuda.synchronize()
    plain_err = float((red - plain).abs().max())
    check(torch.allclose(red, plain, **F32_TOL), f"transposed reduce on launch.train's graph vs plain: {plain_err}")
    scatter_err = float((red - by_scatter).abs().max())
    check(torch.allclose(red, by_scatter, **F32_TOL),
          f"transposed reduce on launch.train's graph vs the scatter route's gradient: {scatter_err}")
    del params, batch
    return {"grads_ell_vs_scatter_max_abs_err": grad_err, "segment_spmm_launches_a_step": launches,
            "transpose_reduce": {"D": cfg.d_hidden, "max_abs_err_vs_plain": plain_err,
                                 "max_abs_err_vs_scatter_gradient": scatter_err},
            "tolerance_grads": GNN_TOL, "tolerance_reduce": F32_TOL}


def gin_training_at_scale(device, graph, host, batch, params, cfg, timer: Timer, *, seed: int) -> tuple[dict, int]:
    """gin-tu training on the large graph: the ELL with its transpose built
    on the host (time), one step's gradients on the ELL route against the
    scatter route's on the same weights, the step's `segment_spmm` launches (5
    forward, 4 backward), the step time of `make_train_step` with AdamW, and
    one transposed reduce at D = 64 beside its bound and `torch.sparse.mm` of
    the transposed adjacency.  Returns the numbers and the launches."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
    from repro_torch.models import gnn
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule

    t0 = time.perf_counter()
    ell = gnn.batch_ell(host, device=device, transpose=True)
    torch.cuda.synchronize()
    build_both_s = time.perf_counter() - t0
    tb = {**batch, "ell": ell}
    start = segment_spmm.launches
    grad_err, launches_a_step = gin_grads_vs_scatter(params, tb, cfg, "the large graph")

    init, step = make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg), adamw(cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)))
    st = init(params)
    losses, walls = [], []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, tb)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        if i:  # the first is warm-up
            walls.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"gin training on the large graph: losses {losses}")
    del st
    train_launches = segment_spmm.launches - start  # the gradient check's step and the 6 steps
    check(train_launches == 7 * launches_a_step, f"gin training on the large graph: {train_launches} reduces")

    n = graph.num_nodes
    ell_t = ell.transpose
    idx = torch.from_numpy(np.stack([graph.src, graph.dst]).astype(np.int64)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")
        a_t = torch.sparse_coo_tensor(idx, torch.ones(graph.num_edges, device=device), (n, n)).coalesce()
        a_t = a_t.to_sparse_csr()
    del idx
    x = torch.from_numpy(np.random.default_rng(seed + 3).standard_normal((n, cfg.d_hidden)).astype(np.float32))
    x = x.to(device)
    with torch.inference_mode():
        red = segment_spmm(x, ell_t)
        lib = torch.sparse.mm(a_t, x)
        torch.cuda.synchronize()
        red_err = float((red - lib).abs().max())
        check(torch.allclose(red, lib, **GIN_REDUCE_TOL), f"transposed reduce vs torch.sparse.mm: {red_err}")
        want = segment_spmm_ref(x, ell_t)
        plain_err = float((red - want).abs().max())
        check(torch.allclose(red, want, **GIN_REDUCE_TOL), f"transposed reduce vs its plain version: {plain_err}")
        del want
        work_t = ell_t.work()
        transpose = {
            "D": cfg.d_hidden, "ms": timer.device_ms(lambda: segment_spmm(x, ell_t), calls=10),
            "call_ms": timer.call_ms(lambda: segment_spmm(x, ell_t), calls=10),
            "bound_ms": gin_reduce_bound_ms(x, ell_t), "bound_by": "bytes",
            "library_ms": timer.call_ms(lambda: torch.sparse.mm(a_t, x), calls=10),
            "library_device_ms": timer.device_ms(lambda: torch.sparse.mm(a_t, x), calls=10),
            "max_abs_err_vs_library": red_err, "max_abs_err_vs_plain": plain_err,
            "plain_ms": timer.call_ms(lambda: segment_spmm_ref(x, ell_t), calls=1, reps=3),
            "ell_t": {"work_items": int(work_t.items.shape[0]), "max_width": int(work_t.items[:, 2].max()),
                      "vertices_in_no_bucket": int(work_t.zero_rows.numel())},
        }
    del red, lib, a_t, x
    torch.cuda.empty_cache()
    return {"build_ell_and_transpose_host_s": build_both_s, "segment_spmm_launches_a_step": launches_a_step,
            "grads_ell_vs_scatter_max_abs_err": grad_err, "losses": losses,
            "step_ms_median": float(np.median(walls)), "step_ms": walls, "transpose_reduce": transpose,
            "timing": "step_ms: host clock around one synchronised make_train_step step (AdamW) on the "
                      "resident batch, 5 after one warm-up; transpose_reduce as reduce.*"}, train_launches


def phase_gnn(device: torch.device, graph, seed: int, smi: str | None, timer: Timer) -> tuple[dict, int]:
    """The four GNN archs at their published widths and depths on
    `full_graph_sm`, gin-tu on `molecule`, and gin-tu on the large graph
    (`gin_at_scale`); `segment_spmm` launches of their forwards."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import arch_ids, get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.models import gnn

    sh = GNN_SHAPES["full_graph_sm"]
    small = rmat(sh["n_nodes"], sh["n_edges"], seed=seed)
    runs = [(arch, "full_graph_sm") for arch in arch_ids("gnn")] + [(GNN_ARCH, "molecule")]
    segment_spmm.launches = 0
    archs = {}
    for arch, cell in runs:
        cfg = get_arch(arch).model_config(cell)
        params = gnn.init_params(cfg, seed, device=device)
        batcher = GraphBatcher(small, d_feat=cfg.d_in, n_classes=cfg.d_out, seed=seed)
        if cfg.kind == "graphcast":
            host = graphcast_batch(sh["n_nodes"], cfg, seed)
        elif cell == "molecule":
            mol = GNN_SHAPES["molecule"]
            host = batcher.molecule_batch(mol["batch"], mol["n_nodes"], mol["n_edges"])
        else:
            host = batcher.full_batch()
        batch = to_device(host, device)
        if cfg.kind == "gin":
            batch["ell"] = gnn.batch_ell(host, device=device)
        with torch.inference_mode():
            before = segment_spmm.launches
            out = gnn.forward(params, batch, cfg)
            torch.cuda.synchronize()
            launches = segment_spmm.launches - before
            loss = float(gnn.loss_fn(params, batch, cfg))
            rows = host["labels"].shape[0]
            check(tuple(out.shape) == (rows, cfg.d_out) and bool(torch.isfinite(out).all()) and np.isfinite(loss),
                  f"{arch} on {cell}: finite outputs of shape ({rows}, {cfg.d_out})")
            check(launches == (cfg.n_layers if cfg.kind == "gin" else 0),
                  f"{arch}: {launches} segment_spmm launches in a forward")
            r = {"kind": cfg.kind, "cell": cell, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
                 "d_in": cfg.d_in, "params": cfg.num_params, "out_shape": list(out.shape), "loss": loss,
                 "segment_spmm_launches_a_forward": launches,
                 "forward_wall_ms": wall_ms(lambda: gnn.forward(params, batch, cfg))}
            if cfg.kind == "gin":
                scatter = dataclasses.replace(cfg, reduce_impl="scatter")
                other = gnn.forward(params, batch, scatter)
                torch.cuda.synchronize()
                r["ell_vs_scatter_max_abs_err"] = float((out - other).abs().max())
                check(torch.allclose(out, other, **GNN_TOL), f"{arch} on {cell}: ell vs scatter route")
                r["scatter_forward_wall_ms"] = wall_ms(lambda: gnn.forward(params, batch, scatter))
            if cfg.kind == "graphcast":
                r["mesh"] = gnn.graphcast_mesh_plan(sh["n_nodes"], cfg.mesh_refinement)
        archs[f"{arch}@{cell}"] = r
        del params, batch
    torch.cuda.empty_cache()
    launches = segment_spmm.launches  # the forwards of the five runs (and their timing)
    wide, wide_launches = gin_at_scale(device, graph, timer, seed=seed, full_scatter=True)
    launches += wide_launches
    out = {
        "archs": archs, "amazon": wide, "segment_spmm_launches": launches, "tolerance_ell_vs_scatter": GNN_TOL,
        "tolerance_reduce": GIN_REDUCE_TOL, "card": smi,
        "cuts": GNN_CUTS,
        "timing": "forward_wall_ms: host clock around one forward that ends in a synchronise, warm median "
                  "of 3, under inference_mode; forward_profile: torch.profiler over one forward (device time "
                  "by kernel, summed; busy share = that sum over the profiled wall); reduce.*: one "
                  "segment_spmm on random N(0,1) x of that width: ms and no_hub_ms replayed from a CUDA graph "
                  "(device time), call_ms, library_ms, scatter_ms, plain_ms enqueued from Python, "
                  "library_device_ms torch.sparse.mm (CSR) replayed; bound_ms: x's read rows, the real "
                  "cols and the output once over 3.35 TB/s",
    }
    say("gnn", **out)
    return out, launches


# --------------------------------------------------------------------------- attention


def attention_flops(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> float:
    """The multiply-adds (×2) of QKᵀ and P·V on the score pairs the mask keeps."""
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    if causal:  # query row i keeps keys 0 .. i + q_offset
        pairs = sum(min(skv, max(0, i + q_offset + 1)) for i in range(sq))
    else:
        pairs = sq * skv
    return 4.0 * b * hq * dh * pairs


def attention_bound_ms(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> tuple[float, str]:
    """Least time for one `flash_attention` call on these inputs: q, k, v read
    once and the output written once over the memory rate, against
    `attention_flops` over the tensor-core (bf16) or CUDA-core (f32) rate."""
    flops = attention_flops(q, k, causal, q_offset)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = flops / (H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_bound_ms(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> tuple[float, str]:
    """Least time for one backward on these inputs: five products a kept
    pair where the forward does two (2.5x `attention_flops`) over the
    tensor-core or CUDA-core rate, against q, k, v, o, dO and lse read once
    and dQ, dK, dV written once over the memory rate."""
    flops = 2.5 * attention_flops(q, k, causal, q_offset)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + q.numel() // q.shape[-1] * 4
    t_ops = flops / (H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_backward(device: torch.device, timer: Timer, qkv) -> dict:
    """The forward kernel's output and log-sum-exp against the plain
    forward's, then the backward kernel on the kernel's forward against
    `flash_attention_bwd_ref` on the plain forward (test shapes, f32 and bf16,
    causal and not, offsets, rows that see no key; two runs bit-equal; the
    training and serve shapes), then its time at the training shape and at
    the serve path's S beside its bound, the plain version and the backward
    of `scaled_dot_product_attention`."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        BWD_ROUTES,
        bwd_consumer_groups,
        bwd_kernel_info,
        bwd_kernel_launches,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(7)
    fwd = {"o_max_abs_err": 0.0, "lse_max_abs_err": 0.0, "cases": 0}

    def largest_diff(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def case(b, sq, skv, hq, hkv, dh, dtype, causal, off):
        """Inputs, the kernel's forward (o, lse) held against the plain
        forward's, and the plain forward (o, lse) for the plain backward."""
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
        o, lse = flash_attention_cuda(q, k, v, causal=causal, q_offset=off, with_lse=True)
        o_ref, lse_ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off, return_lse=True)
        do = torch.randn(o.shape, generator=gen, device=device).to(dtype)
        torch.cuda.synchronize()
        what = (b, sq, skv, hq, hkv, dh, causal, off, str(dtype))
        check(lse.shape == (b, hq, sq) and lse.dtype == torch.float32, f"lse shape/dtype at {what}")
        sees = (torch.arange(sq, device=device) + off >= 0) if causal else torch.ones(sq, dtype=torch.bool,
                                                                                         device=device)
        no_key = ~sees
        check(bool((lse[:, :, no_key] <= LSE_NO_KEY).all() and (lse_ref[:, :, no_key] <= LSE_NO_KEY).all()),
              f"lse of rows that see no key at {what}")
        tag = "f32" if dtype == torch.float32 else "bf16"
        lse_err = largest_diff(lse[:, :, sees], lse_ref[:, :, sees])
        check(torch.allclose(lse[:, :, sees], lse_ref[:, :, sees], **LSE_TOL[tag]),
              f"forward lse vs plain version at {what}: max abs err {lse_err}")
        o_seen, o_ref_seen = o[:, sees].float(), o_ref[:, sees].float()
        o_err = largest_diff(o_seen, o_ref_seen)
        check(torch.allclose(o_seen, o_ref_seen, **(F32_TOL if tag == "f32" else BF16_TOL)),
              f"forward o vs plain version at {what}: {o_err}")
        fwd["o_max_abs_err"] = max(fwd["o_max_abs_err"], o_err)
        fwd["lse_max_abs_err"] = max(fwd["lse_max_abs_err"], lse_err)
        fwd["cases"] += 1
        return q, k, v, o, do, lse, o_ref, lse_ref

    worst = {"f32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    cases = 0
    runs = [(shape, causal, (shape[2] - shape[1]) if causal else 0)
            for shape in ATTN_BWD_TEST_SHAPES for causal in (True, False)]
    runs += [(ATTN_BWD_TEST_SHAPES[-1], True, off) for off in ATTN_BWD_OFFSETS]
    for shape, causal, off in runs:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, o, do, lse, o_ref, lse_ref = case(*shape, dtype, causal, off)
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
            again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
            want = flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            what = (*shape, causal, off, tag)
            check(all(torch.equal(a, b) for a, b in zip(got, again)), f"backward: two runs differ at {what}")
            for a, b in zip(got, want):
                scale = float(b.float().abs().max()) + 1e-6
                err = float((a.float() - b.float()).abs().max())
                check(a.dtype == q.dtype and err <= BWD_REL[tag] * scale,
                      f"backward vs plain version at {what}: {err} of {scale}")
                worst[tag] = max(worst[tag], err / scale)
                max_abs = max(max_abs, err)
            if off < 0:
                check(bool((got[0][:, :-off] == 0).all()), "rows that see no key must add no gradient")
            cases += 1

    timed = {}
    for name, (b, s, hq, hkv, dh) in (("train", ATTN_TRAIN_SHAPE), ("serve", (1, ATTN_TIMED_S, 24, 8, 128))):
        q, k, v, o, do, lse, o_ref, lse_ref = case(b, s, s, hq, hkv, dh, torch.bfloat16, True, 0)
        bound, by = attention_bwd_bound_ms(q, k, True, 0)
        before = bwd_kernel_launches()
        flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        ran = {n: c - before[n] for n, c in bwd_kernel_launches().items()}
        check(ran == BWD_BF16_ROUTE, f"bf16 backward at the {name} shape launched {ran}, want {BWD_BF16_ROUTE}")
        split = kernel_split_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True), ATTN_BWD_GROUPS)
        ms = timer.device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True), calls=5, reps=10)
        # yardstick, used nowhere in the port: the backward of one library call in its own layout
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
        ours = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        plain = flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=True)
        torch.cuda.synchronize()
        held = []
        for got, want in zip(ours, plain):  # the kernel at the path's shape, against its plain version
            scale = float(want.float().abs().max()) + 1e-6
            held.append(float((got.float() - want.float()).abs().max()) / scale)
            check(held[-1] <= BWD_REL["bf16"], f"backward vs plain version at the {name} shape: {held[-1]}")
        worst["bf16"] = max(worst["bf16"], *held)
        del plain
        lib_err = max(float((a.float() - b.transpose(1, 2).float()).abs().max() / (b.float().abs().max() + 1e-6))
                      for a, b in zip(ours, lib))
        timed[name] = {
            "q": [b, s, hq, dh], "k": [b, s, hkv, dh], "dtype": "bfloat16", "causal": True,
            "ms": ms, "call_ms": timer.call_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True),
                                               calls=5, reps=10),
            "tflops": 2.5 * attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12,
            "bound_ms": bound, "bound_by": by,
            "plain_ms": timer.call_ms(lambda: flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=True),
                                      calls=2, reps=3),
            "library_ms": timer.call_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True),
                                        calls=5, reps=10),
            "max_rel_err_vs_plain": max(held), "max_rel_err_vs_library": lib_err,
            "kernels_ms": split if any(split.values()) else "not measured (the profiler saw no kernel)",
            "kernels_launched_a_call": ran,
            "consumer_groups": bwd_consumer_groups(b, s, s, hq, hkv),
        }
        del q, k, v, o, do, lse, o_ref, lse_ref, qt, kt, vt, lib_out, lib, ours
        torch.cuda.empty_cache()
    return {"test_cases": cases, "max_rel_err_f32": worst["f32"], "max_rel_err_bf16": worst["bf16"],
            "max_abs_err": max_abs, "tolerance_rel": BWD_REL, "bit_equal_two_runs": True,
            "forward_with_lse": {**fwd, "tolerance_lse": LSE_TOL, "lse_no_key_at_most": LSE_NO_KEY,
                                 "tolerance_o_f32": F32_TOL, "tolerance_o_bf16": BF16_TOL},
            "rows_that_see_no_key_add_nothing": True, "timed": timed,
            "route_bf16": BWD_ROUTES[torch.bfloat16], "route_f32": BWD_ROUTES[torch.float32],
            "kernel_resources": {"dkdv_dh128": bwd_kernel_info(128, 2, "dkdv"),
                                 **{f"dq_dh128_q{64 * nc}": bwd_kernel_info(128, nc, "dq") for nc in (1, 2)}},
            "timing": "ms: device time replayed from a CUDA graph (one call = the D, dK/dV and dQ kernels); "
                      "kernels_ms: each kernel's device time a call (torch.profiler, device activity, 5 calls); "
                      "kernels_launched_a_call: the library's own launch counts over one call; "
                      "kernel_resources: cudaFuncGetAttributes of the bf16 kernels (registers a thread, "
                      "local_bytes = spills) at dh 128, dQ at one and two consumer warpgroups; "
                      "call_ms, plain_ms (flash_attention_bwd_ref), library_ms (torch.autograd.grad of "
                      "scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, dh) copies, its forward "
                      "done once): calls enqueued back to back; max_rel_err_vs_library: largest difference of a "
                      "gradient over its largest magnitude (each from its own forward), recorded, not checked"}


def phase_attention(device: torch.device, timer: Timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import kernel_info
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(1)

    def qkv(b, sq, skv, hq, hkv, dh, dtype):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device).to(dtype)
                for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]

    def held(q, k, v, causal, off, tol, what):
        got = flash_attention(q, k, v, causal=causal, q_offset=off)
        again = flash_attention(q, k, v, causal=causal, q_offset=off)
        want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        check(got.dtype == q.dtype and got.shape == q.shape, f"shape/dtype at {what}")
        check(torch.equal(got, again), f"two runs differ at {what}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **tol), f"kernel vs plain version at {what}: max abs err {err}")
        return err

    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    for b, sq, skv, hq, hkv, dh in ATTN_TEST_SHAPES:
        for causal in (True, False):
            for dtype, tag, tol in ((torch.float32, "f32", F32_TOL), (torch.bfloat16, "bf16", BF16_TOL)):
                q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
                off = skv - sq if causal else 0
                err = held(q, k, v, causal, off, tol, (b, sq, skv, hq, hkv, dh, causal, tag))
                max_err[tag] = max(max_err[tag], err)
                cases += 1

    # yardstick, used nowhere in the port: one library call in its own (B, H, S, dh) layout
    def library(q, k, v):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    path = []
    timed = None
    for s in ATTN_PATH_S:
        q, k, v = qkv(1, s, s, 24, 8, 128, torch.bfloat16)
        err = held(q, k, v, True, 0, BF16_TOL, ("path", s))
        bound, by = attention_bound_ms(q, k, True, 0)
        ms = timer.device_ms(lambda: flash_attention(q, k, v, causal=True))
        lib = library(q, k, v)
        path.append({"S": s, "max_abs_err": err, "ms": ms, "tflops": attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12,
                     "bound_ms": bound, "bound_by": by, "library_ms": timer.call_ms(lib),
                     "library_device_ms": timer.device_ms(lib)})
        if s == ATTN_TIMED_S:
            timed = (q, k, v)
    path_err = max(p["max_abs_err"] for p in path)
    resources = {f"dh128_q{64 * nc}": kernel_info(128, nc) for nc in (1, 2)}

    q, k, v = timed
    refused = False
    before = flash_attention.launches
    try:
        flash_attention(q, k, v, kv_valid_len=torch.full((1,), 100, device=device))
    except NotImplementedError:
        refused = True
    check(refused and flash_attention.launches == before, "kv_valid_len on the kernel's route must raise")

    ms = timer.device_ms(lambda: flash_attention(q, k, v, causal=True))
    call_ms = timer.call_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = timer.call_ms(lambda: flash_attention_ref(q, k, v, causal=True), calls=3, reps=5)
    lib_fn = library(q, k, v)
    lib = lib_fn().transpose(1, 2)
    ours = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    lib_err = float((lib.float() - ours.float()).abs().max())
    check(torch.allclose(lib.float(), ours.float(), **BF16_TOL), f"kernel vs scaled_dot_product_attention: {lib_err}")
    library_ms = timer.call_ms(lib_fn)
    library_device_ms = timer.device_ms(lib_fn)
    bound_ms, bound_by = attention_bound_ms(q, k, True, 0)
    backward = attention_backward(device, timer, qkv)
    out = {
        "backward": backward,
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL, "bit_equal_two_runs": True,
        "kv_valid_len_refused": refused, "path": path, "path_max_abs_err": path_err,
        "timed_shape": {"q": list(q.shape), "k": list(k.shape), "dtype": "bfloat16", "causal": True},
        "kernel_ms": ms, "kernel_call_ms": call_ms, "ref_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "library_max_abs_err": lib_err, "bound_ms": bound_ms, "bound_by": bound_by,
        "achieved_tflops": attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12,
        "library_device_tflops": attention_flops(q, k, True, 0) / (library_device_ms * 1e-3) / 1e12,
        "kernel_resources": resources,
        "timing": "warm medians with CUDA events. kernel_ms, path[].ms, library_device_ms: device time, "
                  "replayed from a CUDA graph; kernel_call_ms, ref_ms, library_ms: calls enqueued back to back "
                  "from Python. library: scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, dh) "
                  "copies made once. kernel_resources: cudaFuncGetAttributes of the bf16 kernel (registers at "
                  "launch; the consumer warpgroups raise theirs to 232 with setmaxnreg at 128-row tiles)",
    }
    say("attention", **out)
    return out


# --------------------------------------------------------------------------- serve


ATTN_GROUPS = {"flash_attention_ms": ("attn_bf16_wgmma",)}
# the bf16 backward's three kernels (the float32 route's are attn_bwd_dkdv<float, ...>, attn_bwd_dq<...>),
# and what one bf16 call launches, as the library counts them (`kernel.bwd_kernel_launches`)
BWD_BF16_ROUTE = {"attn_bwd_delta": 1, "attn_bwd_dkdv_wgmma": 1, "attn_bwd_dq_wgmma": 1, "attn_bwd_dkdv": 0,
                  "attn_bwd_dq": 0}
ATTN_BWD_GROUPS = {"delta_ms": ("attn_bwd_delta",), "dkdv_wgmma_ms": ("attn_bwd_dkdv_wgmma",),
                   "dq_wgmma_ms": ("attn_bwd_dq_wgmma",)}


def device_rows(prof) -> list[tuple[float, str, int]]:
    """(device µs, kernel name, calls) of a finished `torch.profiler` session,
    device rows only, longest first; the spin kernel that starts a session
    (`profile_window`) is left out."""
    from torch.autograd import DeviceType

    def device_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    return sorted(((device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
                   and "spin_kernel" not in e.key), reverse=True)


def summarize_profile(rows, wall_s: float, groups: dict) -> dict:
    """Device time and busy share over `wall_s`; `groups` maps a key to the
    kernel-name pieces whose device time it sums."""
    total = sum(r[0] for r in rows) / 1e3
    by_group = {key: sum(r[0] for r in rows if any(p in r[1] for p in pieces)) / 1e3
                for key, pieces in groups.items()}
    return {"wall_ms": wall_s * 1e3, "device_ms": total, "device_busy_share": total / (wall_s * 1e3),
            **by_group,
            "top_kernels": [{"name": k[:80], "device_ms": us / 1e3, "calls": n} for us, k, n in rows[:8]]}


def kernel_split_ms(fn, groups: dict, calls: int = 5) -> dict:
    """Device ms a call of `fn` by kernel group (`groups` maps a key to the
    kernel-name pieces it sums), from `torch.profiler` with device activity
    only over `calls` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)), e.key)
            for e in prof.key_averages()]
    return {key: sum(us for us, name in rows if any(p in name for p in pieces)) / 1e3 / calls
            for key, pieces in groups.items()}


def profile_window(fn, groups: dict = ATTN_GROUPS) -> dict:
    """Device time by kernel over one call of `fn` (`torch.profiler`), summed
    over device rows only, beside the wall time; `groups` maps a key to the
    kernel-name pieces whose device time it sums.  A session can lose its
    first kernel (gin-tu's first reduce went missing from one), so a short
    spin kernel goes first and is left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize_profile(device_rows(prof), wall, groups)


def drain_timed(engine, prompts, new_tokens: int, route_logs: dict | None = None):
    """Submit `prompts` and drain `engine`, every prefill and decode call timed
    on the host clock (synchronised on both sides) and its logits checked
    finite; `flash_attention.launches` counts from 0 over the drain.  With
    `route_logs` ({"prefill": [], "decode": []}) each call appends the list
    of its MoE routings (`moe_block.route_log`) there.  Returns (done,
    stats, wall_s, launches)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.moe import moe_block
    from repro_torch.serve.engine import Request

    prefill_one, decode = engine.prefill_one, engine.decode
    st = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_tokens": 0, "decode_tokens": 0, "decode_steps": 0,
          "finite": True}

    def timed(kind, fn, *args):
        if route_logs is not None:
            route_logs[kind].append([])
            moe_block.route_log = route_logs[kind][-1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            out = fn(*args)
            torch.cuda.synchronize()
        finally:
            moe_block.route_log = None
        st[f"{kind}_s"] += time.perf_counter() - t
        return out

    def timed_prefill(cache, slot, tokens):
        cache, logits = timed("prefill", prefill_one, cache, slot, tokens)
        st["prefill_tokens"] += int(tokens.shape[1])
        st["finite"] &= bool(torch.isfinite(logits).all())
        return cache, logits

    def timed_decode(cache, tokens, pos):
        live = sum(a is not None for a in engine.active)
        logits, cache = timed("decode", decode, cache, tokens, pos)
        st["decode_tokens"] += live
        st["decode_steps"] += 1
        st["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    engine.prefill_one, engine.decode = timed_prefill, timed_decode
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    flash_attention.launches = 0  # the path's own count starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = engine.run_until_drained()
        torch.cuda.synchronize()
    finally:
        engine.prefill_one, engine.decode = prefill_one, decode
    return done, st, time.perf_counter() - t0, flash_attention.launches


def logit_checks(cfg, params32: dict, params: dict, toks: torch.Tensor, device: torch.device) -> dict:
    """Full-width logit checks on one prompt `toks` (1, n), each route in a
    one-slot cache of its own: the float32 model through the kernel (prefill,
    and prefill of n - 1 then one decode step) within MODEL_TOL of the float32
    model through the plain attention (the truth); the bf16 model's kernel
    route and decode no further from the truth than its plain route, by
    BF16_ROUTE_FACTOR (mean abs error).  With MoE layers decode is held to a
    truth of its own (the float32 model, plain prefill of n - 1, one decode
    step) beside the bf16 plain route's decode: the prefill's capacity, from
    n tokens, may drop the last token's slots where one decode step's (C = 8)
    drops none, so decode and prefill differ by design.  Raises on a failure."""
    from repro_torch.models import transformer as tfm

    n = toks.shape[1]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def last(c, prm, impl="auto", decode_last=False):
        c = dataclasses.replace(c, attn_impl=impl)
        cache = tfm.init_kv_cache(c, 1, n, dtype=torch.float32, device=device)
        if not decode_last:
            return tfm.prefill(prm, toks, cache, c)[0].float()
        tfm.prefill(prm, toks[:, :-1], cache, c)
        return tfm.decode_step_batched_pos(prm, cache, torch.full((1,), n - 1, device=device), toks[:, -1:], c)[0].float()

    truth = last(cfg32, params32, "ref")  # float32 activations, plain attention
    k32, d32 = last(cfg32, params32), last(cfg32, params32, decode_last=True)
    kb, rb, db = last(cfg, params), last(cfg, params, "ref"), last(cfg, params, decode_last=True)
    if cfg.moe is not None:
        truth_d, rbd = last(cfg32, params32, "ref", decode_last=True), last(cfg, params, "ref", decode_last=True)
    else:
        truth_d, rbd = truth, rb
    torch.cuda.synchronize()

    def err(a, b):
        return float((a - b).abs().max()), float((a - b).abs().mean())

    checks = {
        "prompt_tokens": n, "truth": "float32 activations, impl='ref'", "truth_std": float(truth.std()),
        "f32_kernel_vs_ref": err(k32, truth), "f32_decode_vs_prefill": err(d32, k32),
        "bf16_kernel_vs_truth": err(kb, truth), "bf16_ref_vs_truth": err(rb, truth),
        "bf16_decode_vs_truth": err(db, truth), "bf16_kernel_vs_ref": err(kb, rb),
        "bf16_kernel_vs_ref_within_one_op_tolerance": float(
            torch.isclose(kb, rb, **BF16_TOL).float().mean()),
        "argmax_equal_kernel_ref_truth": [int(kb.argmax()), int(rb.argmax()), int(truth.argmax())],
        "tolerance_f32": MODEL_TOL, "bf16_route_factor": BF16_ROUTE_FACTOR, "errors": "[max abs, mean abs]",
    }
    check(torch.allclose(k32, truth, **MODEL_TOL), f"f32 logits, kernel vs ref: {checks['f32_kernel_vs_ref']}")
    floor = checks["bf16_ref_vs_truth"][1]
    check(checks["bf16_kernel_vs_truth"][1] <= BF16_ROUTE_FACTOR * floor,
          f"bf16 logits, kernel route less accurate than the plain route: {checks}")
    if cfg.moe is None:
        check(torch.allclose(d32, k32, **MODEL_TOL),
              f"f32 logits, decode vs prefill: {checks['f32_decode_vs_prefill']}")
        check(checks["bf16_decode_vs_truth"][1] <= BF16_ROUTE_FACTOR * floor,
              f"bf16 logits, decode less accurate than the plain prefill: {checks}")
        return checks
    checks.update({"decode_truth": "float32 activations, impl='ref' prefill of n - 1, one decode step",
                   "f32_decode_vs_decode_truth": err(d32, truth_d), "bf16_decode_vs_decode_truth": err(db, truth_d),
                   "bf16_ref_decode_vs_decode_truth": err(rbd, truth_d)})
    check(torch.allclose(d32, truth_d, **MODEL_TOL), f"f32 logits, decode vs its truth: {checks}")
    check(checks["bf16_decode_vs_decode_truth"][1] <= BF16_ROUTE_FACTOR * checks["bf16_ref_decode_vs_decode_truth"][1],
          f"bf16 logits, decode less accurate than the plain route's decode: {checks}")
    return checks


def phase_serve(device: torch.device, seed: int, smi: str | None) -> tuple[dict, int]:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import gqa_attention

    cfg = get_arch(SERVE_ARCH).model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = tfm.init_params(cfg, seed, device=device)  # a seeded torch.Generator on the card
    params = tfm.cast_params(params32, cfg)  # the weights as served: one bf16 copy
    engine = build_engine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shape = (cfg.n_layers, SERVE_SLOTS, SERVE_MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    check(engine.cache["k"].dtype == torch.float32 and tuple(engine.cache["k"].shape) == shape, "the KV cache")

    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]

    # first use of each operator (cuBLAS handles, kernel loads) before anything is timed
    prefill_one, decode = engine.prefill_one, engine.decode
    engine.cache, _ = prefill_one(engine.cache, 0, torch.from_numpy(prompts[0][None, :256].astype(np.int64)))
    _, engine.cache = decode(engine.cache, torch.zeros((SERVE_SLOTS, 1), dtype=torch.long),
                             torch.zeros(SERVE_SLOTS, dtype=torch.long))
    torch.cuda.synchronize()

    done, st, wall_s, launches = drain_timed(engine, prompts, SERVE_NEW)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == SERVE_REQUESTS, f"{len(done)} of {SERVE_REQUESTS} requests drained")
    for r in done:
        check(len(r.out_tokens) == SERVE_NEW or r.out_tokens[-1] == engine.eos_id,
              f"request {r.uid}: {len(r.out_tokens)} tokens")
    check(launches == cfg.n_layers * SERVE_REQUESTS, f"flash_attention launched {launches} times, "
          f"want {cfg.n_layers} a prefill × {SERVE_REQUESTS}")
    check(st["finite"], "non-finite logits")

    # full-width logit checks on request 0's prompt
    toks = torch.from_numpy(prompts[0][None, :].astype(np.int64)).to(device)
    checks = logit_checks(cfg, params32, params, toks, device)
    checks["first_token_engine"] = done[[r.uid for r in done].index(0)].out_tokens[0]
    del params32

    # where the time goes: one prefill (request 0's prompt, slot 0) and 8 decode steps
    pos = torch.from_numpy(engine.pos.astype(np.int64))
    prof_prefill = profile_window(lambda: prefill_one(engine.cache, 0, toks.cpu()))
    check(prof_prefill["flash_attention_ms"] > 0, "the prefill profile found no flash-attention kernel by name")
    step_tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long)

    def eight_steps():
        for _ in range(8):
            decode(engine.cache, step_tokens, pos)

    prof_decode = profile_window(eight_steps)
    # decode attention alone at the engine's shapes: 4 slots over the float32 cache
    qd = torch.randn((SERVE_SLOTS, 1, cfg.n_heads, cfg.head_dim), device=device).bfloat16()
    valid = torch.full((SERVE_SLOTS,), 2048, device=device)
    ck, cv = engine.cache["k"][0], engine.cache["v"][0]
    timer = Timer()
    decode_attn_ms = timer.call_ms(lambda: gqa_attention(qd, ck, cv, causal=False, kv_valid_len=valid))

    out = {
        "arch": SERVE_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "params": cfg.num_params, "activations": "bfloat16", "cuts": [],
        "slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ, "kv_cache": "float32",
        "requests": SERVE_REQUESTS, "prompt_lengths": [int(x) for x in lengths], "max_new_tokens": SERVE_NEW,
        "new_tokens": [len(r.out_tokens) for r in sorted(done, key=lambda r: r.uid)],
        "setup_s": setup_s, "wall_s": wall_s,
        "prefill_s": st["prefill_s"], "prefill_tokens": st["prefill_tokens"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "decode_s": st["decode_s"], "decode_steps": st["decode_steps"], "decode_tokens": st["decode_tokens"],
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "flash_attention_launches": launches, "max_memory_allocated_gb": peak_gb,
        "logit_checks": checks,
        "profile_prefill": prof_prefill, "profile_8_decode_steps": prof_decode,
        "decode_attention_layer_ms": decode_attn_ms,
        "timing": "host clock around each prefill / decode call, synchronised on both sides; "
                  "profiles with torch.profiler after the drain; decode_attention_layer_ms: one layer's "
                  "gqa_attention at the engine's decode shapes, calls back to back, CUDA events",
        "card": smi,
    }
    say("serve", **out)
    return out, launches


# --------------------------------------------------------------------------- training

LM_TRAIN_ARCH = "llama3.2-3b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128  # launch.train's defaults
GNN_TRAIN_ARCHS = ("gin-tu", "gat-cora", "pna")
PROFILED_STEP = 5  # one step in the first half, so the last ten are not slowed by the profiler
LM_GROUPS = {"gemm_ms": ("gemm", "xmma", "cutlass", "nvjet", "sm90_"), "attention_forward_ms": ("attn_bf16_wgmma",),
             "attention_backward_ms": ("attn_bwd_",)}


class StepRecorder:
    """`on_step` for `launch.train.train`: each step's loss and the host
    clock at its synchronised end; `torch.profiler` over step PROFILED_STEP
    alone (started at the end of the step before it)."""

    def __init__(self, groups: dict):
        self.losses, self.ends, self.groups = [], [], groups
        self.profile = None
        self._prof = None

    def __call__(self, state, metrics, batch):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.losses.append(metrics["loss"])
        self.ends.append(now)
        if metrics["step"] == PROFILED_STEP - 1:
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
        elif metrics["step"] == PROFILED_STEP:
            self._prof.__exit__(None, None, None)
            self.profile = summarize_profile(device_rows(self._prof), now - self._t0, self.groups)
            self._prof = None

    def step_ms(self) -> float:
        """Median wall of the last ten steps (end to end of consecutive steps)."""
        walls = np.diff(self.ends)[-10:] * 1e3
        return float(np.median(walls))

    def float_losses(self) -> list[float]:
        return [float(x) for x in self.losses]


def phase_train(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """`launch.train.train`, the code path of `python -m repro_torch.launch.train`:
    llama3.2-3b at its published width and depth for TRAIN_STEPS steps at the
    reference's defaults (batch 8, seq 128, lr 1e-3, AdamW with clip 1.0, a
    recompute a layer), then gin-tu, gat-cora and pna at `full_graph_sm`'s
    widths on the reference's graph (R-MAT, 512 nodes, 4,096 edges), and
    graphcast refused.  The kernels' counts are set to 0 just before and read
    just after; returns the numbers and the counts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import bwd_kernel_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.launch.train import GRAPHCAST_REFUSAL, train
    from repro_torch.train.optim import adamw, cosine_schedule

    cfg = get_arch(LM_TRAIN_ARCH).model_config()
    rec = StepRecorder(LM_GROUPS)
    log = []
    gc.collect()  # what the earlier phases left in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = segment_spmm.launches = 0
    bwd_before = bwd_kernel_launches()
    t0 = time.perf_counter()
    state = train(LM_TRAIN_ARCH, steps=TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, lr=TRAIN_LR,
                  device=device, seed=seed, on_step=rec, log_fn=log.append)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "flash_attention_bwd": flash_attention_bwd.launches}
    bwd_kernels = {n: c - bwd_before[n] for n, c in bwd_kernel_launches().items()}
    check(bwd_kernels == {n: c * launches["flash_attention_bwd"] for n, c in BWD_BF16_ROUTE.items()},
          f"the backward's kernels on the training path: {bwd_kernels}, want the bf16 wgmma route each call")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = rec.float_losses()
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS, f"llama trained {state.step} steps")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"llama losses: {losses}")
    check(launches["flash_attention"] == 2 * cfg.n_layers * TRAIN_STEPS,
          f"attention forward launches {launches['flash_attention']}, want 2 a layer a step (recompute)")
    check(launches["flash_attention_bwd"] == cfg.n_layers * TRAIN_STEPS,
          f"attention backward launches {launches['flash_attention_bwd']}, want 1 a layer a step")
    check(segment_spmm.launches == 0, "the LM path launched the ELL reduce")
    step_ms = rec.step_ms()
    # the optimizer alone: one AdamW update (clip included) of every leaf, after training.  The
    # params stand in for their own gradients (a 14.4 GB gradient tree would not fit beside
    # params, mu and nu); the same work on the same shapes, and the values are thrown away
    opt = adamw(cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    opt_ms = []
    for _ in range(3):
        ev[0].record()
        opt.update(state.params, state.opt_state, state.params, TRAIN_STEPS)
        ev[1].record()
        torch.cuda.synchronize()
        opt_ms.append(ev[0].elapsed_time(ev[1]))
    del state
    torch.cuda.empty_cache()
    prof = rec.profile
    prof["optimizer_ms_measured_alone"] = statistics.median(opt_ms)
    prof["other_ms"] = prof["device_ms"] - prof["gemm_ms"] - prof["attention_forward_ms"] - prof["attention_backward_ms"]
    lm = {
        "arch": LM_TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": cfg.num_params,
        "param_dtype": "float32", "activations": "bfloat16", "remat": cfg.remat, "cuts": [],
        "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
        "wall_s": wall_s, "step_ms_median_last10": step_ms,
        "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (step_ms / 1e3),
        "max_memory_allocated_gb": peak_gb, "profile_one_step": prof,
        "flash_attention_launches_a_step": launches["flash_attention"] / TRAIN_STEPS,
        "flash_attention_bwd_launches_a_step": launches["flash_attention_bwd"] / TRAIN_STEPS,
        "flash_attention_bwd_kernel_launches": bwd_kernels,
        "log": log,
    }

    gnns = {}
    segment_spmm.launches = 0
    for arch in GNN_TRAIN_ARCHS:
        gcfg = get_arch(arch).model_config("full_graph_sm")
        grec = StepRecorder({"segment_fused_ms": ("segment_fused",), "gemm_ms": ("gemm", "xmma", "cutlass", "nvjet")})
        before = segment_spmm.launches
        st = train(arch, steps=TRAIN_STEPS, lr=TRAIN_LR, device=device, seed=seed, on_step=grec,
                   log_fn=lambda _: None)
        torch.cuda.synchronize()
        n_launch = segment_spmm.launches - before
        gl = grec.float_losses()
        check(st.step == TRAIN_STEPS and all(np.isfinite(gl)), f"{arch}: losses {gl}")
        want = (2 * gcfg.n_layers - 1) * TRAIN_STEPS if gcfg.kind == "gin" else 0
        check(n_launch == want, f"{arch}: {n_launch} segment_spmm launches in training, want {want}")
        gnns[arch] = {"kind": gcfg.kind, "layers": gcfg.n_layers, "d_hidden": gcfg.d_hidden, "d_in": gcfg.d_in,
                      "params": gcfg.num_params, "losses": gl, "step_ms_median_last10": grec.step_ms(),
                      "segment_spmm_launches_a_step": n_launch / TRAIN_STEPS, "profile_one_step": grec.profile}
        del st
    gnn_launches = segment_spmm.launches
    gnns[GNN_ARCH]["held_against_scatter"] = gin_training_held(device, seed)  # after the count is read
    refused = None
    try:
        train("graphcast", steps=1, device=device, seed=seed, log_fn=lambda _: None)
    except SystemExit as e:
        refused = str(e)
    check(refused == GRAPHCAST_REFUSAL, f"graphcast training must be refused as the reference refuses it: {refused}")
    torch.cuda.empty_cache()
    out = {
        "lm": lm, "gnn": gnns, "gnn_graph": "rmat(512, 4096, seed 0), GraphBatcher.full_batch (launch.train)",
        "graphcast_refused": refused, "segment_spmm_launches": gnn_launches,
        "timing": "step_ms_median_last10: host clock between the synchronised ends of consecutive loop steps "
                  "(batch fetch, step and the loop's bookkeeping), median of the last 10; profile_one_step: "
                  "torch.profiler over step 5 alone (device time by kernel, busy share = that over the step's "
                  "wall); optimizer_ms_measured_alone: one AdamW update (clip included) of every leaf after "
                  "training, the params standing in for the gradients, CUDA events, median of 3",
        "card": smi,
    }
    say("train", **out)
    return out, {**launches, "segment_spmm": gnn_launches}


# --------------------------------------------------------------------------- embedding bag


def bag_bound_ms(tables: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None) -> tuple[float, str, int]:
    """Least time for one `embedding_bag` call on these inputs: the ids (and
    weights) read once, each distinct (t, id) row once in whole 32-byte
    sectors, and the output written once, over the memory rate — hot Zipf
    rows come again and again, and a bound that counted every gathered row
    would be beaten by the L2 — against the multiply-adds of the real slots
    over the f32 rate.  Returns (ms, what bounds it, distinct rows)."""
    t, v, d = tables.shape
    b = ids.shape[0]
    valid = (ids >= 0) & (ids < v)
    rows = (torch.arange(t, device=ids.device)[None, :, None] * v + ids.long())[valid]
    distinct = int(torch.unique(rows).numel())
    item = tables.element_size()
    row_bytes = -(-d * item // SECTOR_BYTES) * SECTOR_BYTES
    nbytes = distinct * row_bytes + ids.numel() * 4 + (weights.numel() * 4 if weights is not None else 0)
    nbytes += b * t * d * item
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * int(valid.sum()) * d / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), distinct


def library_bag(tables: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None):
    """The same function as one `F.embedding_bag` call (the yardstick; used
    nowhere in the port): tables viewed as (T·V, D), ids offset by t·V and
    clamped, `mode="sum"`, per-sample weights w·valid.  The inputs are
    prepared once; the returned callable is the call alone."""
    import torch.nn.functional as F

    t, v, d = tables.shape
    b, _, l = ids.shape
    valid = (ids >= 0) & (ids < v)
    flat = (ids.long().clamp(0, v - 1) + torch.arange(t, device=ids.device)[None, :, None] * v).reshape(b * t, l)
    psw = (valid.float() if weights is None else weights * valid).reshape(b * t, l)
    table2d = tables.view(t * v, d)
    return lambda: F.embedding_bag(flat, table2d, mode="sum", per_sample_weights=psw).view(b, t, d)


def phase_bag(device: torch.device, seed: int, timer: Timer) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import RecsysPipeline
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    rng = np.random.default_rng(2)

    def inputs(t, v, d, b, l):
        tables = torch.from_numpy(rng.standard_normal((t, v, d)).astype(np.float32)).to(device)
        ids = torch.from_numpy(rng.integers(-2, v, (b, t, l)).astype(np.int32)).to(device)  # with padding ids
        w = torch.from_numpy(rng.standard_normal((b, t, l)).astype(np.float32)).to(device)
        return tables, ids, w

    def held(tables, ids, w, tol, what):
        got, again, want = embedding_bag(tables, ids, w), embedding_bag(tables, ids, w), embedding_bag_ref(tables, ids, w)
        torch.cuda.synchronize()
        check(got.dtype == tables.dtype and got.shape == (ids.shape[0], tables.shape[0], tables.shape[2]),
              f"shape/dtype at {what}")
        check(torch.equal(got, again), f"two runs differ at {what}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **tol), f"kernel vs plain version at {what}: max abs err {err}")
        return got, err

    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    grad_err = 0.0
    for shape in BAG_TEST_SHAPES:
        tables32, ids, w = inputs(*shape)
        for dtype, tag, tol in ((torch.float32, "f32", F32_TOL), (torch.bfloat16, "bf16", BF16_TOL)):
            for ww in (w, None):
                _, err = held(tables32.to(dtype), ids, ww, tol, (*shape, tag, ww is not None))
                max_err[tag] = max(max_err[tag], err)
                cases += 1
        # gradients of tables and weights through the kernel's autograd.Function
        # against autograd through the plain version
        g = torch.from_numpy(rng.standard_normal((shape[3], shape[0], shape[2])).astype(np.float32)).to(device)
        t1, w1 = tables32.clone().requires_grad_(), w.clone().requires_grad_()
        before = embedding_bag.launches
        (embedding_bag(t1, ids, w1) * g).sum().backward()
        check(embedding_bag.launches == before + 1, "the gradient's forward must be the kernel")
        t2, w2 = tables32.clone().requires_grad_(), w.clone().requires_grad_()
        (embedding_bag_ref(t2, ids, w2) * g).sum().backward()
        for a, b_, name in ((t1.grad, t2.grad, "tables"), (w1.grad, w2.grad, "weights")):
            e = float((a - b_).abs().max())
            check(torch.allclose(a, b_, **F32_TOL), f"d {name} at {shape}: max abs err {e}")
            grad_err = max(grad_err, e)

    # the path's lookup: dcn-v2's tables, Zipf ids from its pipeline
    cfg = get_arch(RECSYS_ARCH).model_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = torch.randn((cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim), generator=gen,
                         device=device).mul_(0.01)  # init_params' scale
    t0 = time.perf_counter()
    single = next(iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, BAG_PATH_BATCH, seed=seed)))
    batch_host_s = time.perf_counter() - t0
    multi = next(iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, BAG_MULTI_BATCH,
                                     multi_hot=BAG_MULTI_HOT, seed=seed)))
    lookups = {
        "single_hot": (torch.from_numpy(single["sparse_ids"]).to(device)[..., None], None),
        "multi_hot_weighted": (torch.from_numpy(multi["sparse_ids"]).to(device),
                               torch.from_numpy(rng.random(multi["sparse_ids"].shape, dtype=np.float32)).to(device)),
    }
    path = {}
    for name, (ids, w) in lookups.items():
        got, err = held(tables, ids, w, F32_TOL, name)
        lib_fn = library_bag(tables, ids, w)
        lib = lib_fn()
        torch.cuda.synchronize()
        lib_err = float((lib - got).abs().max())
        check(torch.allclose(lib, got, **F32_TOL), f"kernel vs F.embedding_bag at {name}: {lib_err}")
        bound, by, distinct = bag_bound_ms(tables, ids, w)
        path[name] = {
            "B": int(ids.shape[0]), "T": int(ids.shape[1]), "L": int(ids.shape[2]), "V": cfg.rows_per_table,
            "D": cfg.embed_dim, "weighted": w is not None, "distinct_rows": distinct,
            "gathered_rows": int(ids.numel()), "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": timer.device_ms(lambda: embedding_bag(tables, ids, w)),
            "call_ms": timer.call_ms(lambda: embedding_bag(tables, ids, w)),
            "plain_ms": timer.call_ms(lambda: embedding_bag_ref(tables, ids, w), calls=5, reps=5),
            "library_ms": timer.call_ms(lib_fn),
            "bound_ms": bound, "bound_by": by,
        }
    out = {
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "grad_max_abs_err": grad_err, "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL,
        "bit_equal_two_runs": True, "path": path,
        "path_max_abs_err": max(p["max_abs_err"] for p in path.values()),
        "zipf_batch_host_ms": batch_host_s * 1e3,
        "timing": "warm medians with CUDA events. ms: device time, replayed from a CUDA graph; call_ms, "
                  "plain_ms, library_ms: calls enqueued back to back from Python. library: F.embedding_bag "
                  "(mode='sum', per_sample_weights=w·valid) on tables.view(T·V, D) with ids offset by t·V "
                  "and clamped, prepared once. zipf_batch_host_ms: RecsysPipeline's first batch of 65,536",
    }
    say("embedding_bag", **out)
    return out


# --------------------------------------------------------------------------- recsys


def phase_recsys(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, int]:
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import RecsysPipeline, to_device
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.launch.train import train
    from repro_torch.models import recsys as rec
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule

    cfg = get_arch(RECSYS_ARCH).model_config()
    plain = dataclasses.replace(cfg, bag_impl="ref")
    check(cfg.num_params == RECSYS_PARAMS, f"dcn-v2 has {cfg.num_params} params, want {RECSYS_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rec.init_params(cfg, seed, device=device)  # a seeded torch.Generator on the card
    # `num_params` is the reference's formula, which counts 2·d0 a cross layer
    # for what is one d0 bias: the tensors hold n_cross·d0 fewer
    held_params = sum(t.numel() for t in [params["tables"]] + [
        t for lp in params["cross"] + params["mlp"] + [params["out"]] for t in lp.values()])
    check(held_params == RECSYS_PARAMS - cfg.n_cross_layers * cfg.d_input, f"params made: {held_params}")

    def first_batch(batch_size):
        return next(iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, batch_size, seed=seed)))

    cells = ("serve_p99", "serve_bulk")
    batches = {c: to_device(first_batch(RECSYS_SHAPES[c]["batch"]), device) for c in cells}
    query = to_device(first_batch(RECSYS_SHAPES["retrieval_cand"]["batch"]), device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    cands = torch.randn((n_cand, cfg.mlp_dims[-1]), generator=gen, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ---- the main path: serve, retrieve, train (the kernel's route)
    losses, walls = [], []
    first = torch.full((cfg.n_sparse * cfg.rows_per_table,), -1, dtype=torch.int16, device=device)
    offsets = torch.arange(cfg.n_sparse, device=device) * cfg.rows_per_table

    def on_step(state, metrics, batch):
        losses.append(metrics["loss"])
        rows = (batch["sparse_ids"].long() + offsets).reshape(-1)
        first[rows] = torch.where(first[rows] < 0, metrics["step"], first[rows]).to(torch.int16)
        torch.cuda.synchronize()
        walls.append(time.perf_counter())

    train_log = []
    embedding_bag.launches = 0
    torch.cuda.synchronize()
    with torch.inference_mode():
        logits = {c: rec.forward(params, batches[c], cfg) for c in cells}
        vals, idx = rec.retrieval_scores(params, query, cands, cfg, top_k=100)
    serve_launches = embedding_bag.launches
    t_train = time.perf_counter()
    state = train(RECSYS_ARCH, steps=TRAIN_STEPS, batch=RECSYS_SHAPES["train_batch"]["batch"], lr=TRAIN_LR,
                  device=device, seed=seed, on_step=on_step, log_fn=train_log.append)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    launches = embedding_bag.launches
    check(serve_launches == len(cells) + 1, f"embedding_bag launched {serve_launches} times in serving, want 3")
    check(launches == serve_launches + TRAIN_STEPS, f"embedding_bag launched {launches} times, want "
          f"{len(cells) + 1} + {TRAIN_STEPS}")
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS, f"trained {state.step} steps")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")

    # ---- serving against the plain route
    serve = {}
    with torch.inference_mode():
        for c in cells:
            want = rec.forward(params, batches[c], plain)
            torch.cuda.synchronize()
            e = float((logits[c] - want).abs().max())
            check(logits[c].shape == (RECSYS_SHAPES[c]["batch"],) and bool(torch.isfinite(logits[c]).all()),
                  f"{c}: logits")
            check(torch.allclose(logits[c], want, **MODEL_TOL), f"{c}: kernel vs plain route, max abs err {e}")
            ms = timer.call_ms(lambda: rec.forward(params, batches[c], cfg), calls=5, reps=5)
            serve[c] = {"batch": RECSYS_SHAPES[c]["batch"], "max_abs_err_vs_plain": e, "ms": ms,
                        "rows_per_s": RECSYS_SHAPES[c]["batch"] / (ms / 1e3),
                        "plain_ms": timer.call_ms(lambda: rec.forward(params, batches[c], plain), calls=5, reps=5)}
        scores = rec.user_tower(params, query, cfg) @ cands.T
        top = scores.float().sort(dim=-1, descending=True).values[:, :100]
        torch.cuda.synchronize()
        check(vals.shape == (1, 100) and torch.equal(vals, top), "retrieval top-100 vs the sorted full scores")
        check(float(vals[0, 0]) == float(scores.max()), "retrieval: the best score is the maximum")
        check(torch.equal(scores[0, idx[0]].float(), vals[0]), "retrieval: indices point at their values")
        retrieval = {"candidates": n_cand, "width": cfg.mlp_dims[-1], "top_k": 100,
                     "candidates_gb": cands.numel() * 4 / 1e9, "top_equals_sorted_full_scores": True,
                     "ms": timer.call_ms(lambda: rec.retrieval_scores(params, query, cands, cfg), calls=5, reps=5)}
    del cands, scores

    # ---- training: gradient reached the tables through the kernel's Function
    decay = 1.0
    lr_fn = cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)
    for k in range(TRAIN_STEPS):
        decay *= 1.0 - lr_fn(k) * 0.1  # adamw's weight decay, the only force on a row never looked up

    def changed_rows(tables):
        p0 = params["tables"].reshape(-1, cfg.embed_dim)
        p1 = tables.detach().reshape(-1, cfg.embed_dim)
        return ~((p1 - p0 * decay).abs() <= DECAY_RTOL * p0.abs() + 1e-12).all(dim=1)

    changed = changed_rows(state.params["tables"])
    touched = first >= 0
    n_touched, n_changed = int(touched.sum()), int(changed[touched].sum())
    unchanged_by_first_step = [int((~changed & (first == k)).sum()) for k in range(TRAIN_STEPS)]
    check(not bool(changed[~touched].any()), "a table row never looked up changed by more than weight decay")
    check(sum(unchanged_by_first_step[:TRAIN_STEPS // 2]) == 0,
          f"rows first looked up in the first half did not change: {unchanged_by_first_step}")
    check(n_changed >= ROWS_CHANGED_MIN_SHARE * n_touched, f"only {n_changed} of {n_touched} looked-up rows changed")

    # host share: a step on a resident batch (device time) against the loop's wall time a step
    step_walls = np.diff(walls)
    init, step = make_train_step(lambda p, b: rec.loss_fn(p, b, cfg), adamw(lr_fn))
    st = init(state.params)
    resident = to_device(first_batch(RECSYS_SHAPES["train_batch"]["batch"]), device)
    for _ in range(2):
        st, _ = step(st, resident)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        st, _ = step(st, resident)
    b.record()
    torch.cuda.synchronize()
    step_device_ms = a.elapsed_time(b) / 5
    t0 = time.perf_counter()
    host = iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, RECSYS_SHAPES["train_batch"]["batch"],
                               seed=seed + 1))
    for _ in range(3):
        next(host)
    batch_host_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del st, state

    # ---- the same 20 steps through the plain route
    ref_losses = []
    torch.cuda.empty_cache()
    before = embedding_bag.launches
    ref_state = train(RECSYS_ARCH, steps=TRAIN_STEPS, batch=RECSYS_SHAPES["train_batch"]["batch"], lr=TRAIN_LR,
                      device=device, seed=seed, bag_impl="ref",
                      on_step=lambda s, m, bt: ref_losses.append(m["loss"]), log_fn=lambda _: None)
    ref_losses = [float(x) for x in ref_losses]
    check(embedding_bag.launches == before, "the plain route launched the kernel")
    loss_diff = float(np.max(np.abs(np.array(losses) - np.array(ref_losses))))
    check(loss_diff <= TRAIN_LOSS_TOL, f"losses, kernel vs plain route: max abs diff {loss_diff}")
    disagree = int((changed_rows(ref_state.params["tables"]) != changed)[touched].sum())
    check(disagree <= ROUTES_ROW_DISAGREEMENT_MAX * n_touched,
          f"the routes change different looked-up rows: {disagree} of {n_touched}")
    del ref_state

    wall_ms = float(np.median(step_walls[1:])) * 1e3
    out = {
        "arch": RECSYS_ARCH, "params": cfg.num_params, "params_held": held_params,
        "params_gb": held_params * 4 / 1e9,
        "tables": [cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim], "d_input": cfg.d_input,
        "mlp": list(cfg.mlp_dims), "cross_layers": cfg.n_cross_layers, "cuts": [],
        "setup_s": setup_s, "serve": serve, "retrieval": retrieval,
        "train": {
            "batch": RECSYS_SHAPES["train_batch"]["batch"], "steps": TRAIN_STEPS, "lr": TRAIN_LR,
            "losses": losses, "plain_route_losses": ref_losses, "loss_max_abs_diff": loss_diff,
            "loss_tolerance": TRAIN_LOSS_TOL, "rows_looked_up": n_touched,
            "rows_looked_up_changed": n_changed, "rows_never_looked_up_only_decayed": True,
            "rows_unchanged_by_first_step": unchanged_by_first_step,
            "rows_change_status_differs_from_plain_route": disagree, "decay_factor": decay, "wall_s": train_s, "step_wall_ms_median": wall_ms,
            "step_device_ms": step_device_ms, "zipf_batch_host_ms": batch_host_ms,
            "host_share": max(0.0, 1.0 - step_device_ms / wall_ms), "log": train_log,
        },
        "embedding_bag_launches": launches, "serve_launches": serve_launches,
        "max_memory_allocated_gb": peak_gb,
        "timing": "serve/retrieval ms: calls enqueued back to back, CUDA events (plain_ms: the plain "
                  "embedding-bag route); step_wall_ms_median: host clock between the ends of consecutive "
                  "loop steps, each synchronised; step_device_ms: 5 steps on one resident batch between two "
                  "CUDA events; host_share = 1 - step_device_ms / step_wall_ms_median",
        "card": smi,
    }
    say("recsys", **out)
    return out, launches


# --------------------------------------------------------------------------- sweep CLI


def _pagerank_iterations(records: list[dict]) -> int:
    """One `segment_spmm` launch a PageRank iteration, one trace a workload."""
    return sum({r["workload"]: r["num_iterations"] for r in records if r["algorithm"] == "pagerank"}.values())


def phase_cli(smi: str | None) -> tuple[dict, int]:
    """The sweep CLI as its users run it (`python -m repro_torch.experiments.run`),
    in process so the launch counts can be read: `--grid backpressure` and
    `--grid faults` at CLI_SCALE (amazon and soc-pokec), the faults grid again
    with `--resume`, then `--grid paper` at its own scale rendering the port's
    EXPERIMENTS.md with both folded in; `--check` on those outputs, and the
    paper records against the reference package's committed numpy run of the
    same grid, scale and seed (`BENCH_sweep.json`).  Each grid has a cache of
    its own, so each traces."""
    import os
    import tempfile

    from repro_torch.experiments import report
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.experiments.run import main as run_main
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    def drive(*argv: str) -> tuple[float, int]:
        segment_spmm.launches = ell_spmm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = run_main([*argv, "-q"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"run {' '.join(argv)} exited {rc}")
        check(ell_spmm.launches == 0, f"run {' '.join(argv)} launched the one-bucket kernel")
        return wall, segment_spmm.launches

    def finite(values) -> bool:
        return all(np.isfinite(v) for v in values if isinstance(v, float))

    scale = f"{CLI_SCALE:g}"
    cuts = [] if CLI_SCALE == 1.0 else [f"backpressure and faults grids at --scale {scale}"]
    out: dict = {"scale": CLI_SCALE, "cuts": cuts}
    with tempfile.TemporaryDirectory() as tmp:
        sweeps = os.path.join(tmp, "sweeps")

        def paths(grid: str) -> list[str]:
            return ["--sweeps-dir", sweeps, "--cache-dir", os.path.join(tmp, f"cache_{grid}")]

        # 1. backpressure: both routing arms, open loop and credit at every depth
        wall, launches = drive("--grid", "backpressure", "--scale", scale, *paths("backpressure"))
        with open(os.path.join(sweeps, "backpressure.json")) as f:
            bp = json.load(f)
        cont = bp["contention"]
        check(len(bp["records"]) == GRIDS["backpressure"].num_configs == 12, "backpressure: 12 configurations")
        check(len(cont["records"]) == 12 * 2 * (len(cont["buffer_depths"]) + 1), "a contention record an arm")
        check(cont["backends"] == ["numpy", "torch"] and cont["backend_parity_max_rel"] <= cont["parity_rtol"],
              f"backpressure numpy↔torch parity {cont['backend_parity_max_rel']}")
        check(cont["credit_inf_numpy_max_abs"] == 0.0 and cont["credit_inf_torch_max_rel"] <= cont["parity_rtol"],
              "credit@inf differs from the open arm")
        check(all(finite(r.values()) for r in bp["records"] + cont["records"]), "non-finite backpressure record")
        check(launches == _pagerank_iterations(bp["records"]) > 0,
              f"backpressure: {launches} segment_spmm launches, not one a PageRank iteration")
        soc = bp["workload_stats"]["soc-pokec"]
        out["backpressure"] = {
            "wall_s": wall, "timings": bp["timings"], "records": len(bp["records"]),
            "contention_records": len(cont["records"]), "parity_max_rel": cont["backend_parity_max_rel"],
            "credit_inf_torch_max_rel": cont["credit_inf_torch_max_rel"],
            "min_speedup": min(c["speedup"] for c in bp["comparisons"]),
            "segment_spmm_launches": launches, "ell_spmm_launches": 0,
        }
        out["soc_pokec"] = {"scale": CLI_SCALE, "nodes": soc["num_nodes"], "edges": soc["num_edges"],
                            "max_degree": soc["max_degree"]}

        # 2. faults: every unit, then the same command resumed from its journal
        fargs = ("--grid", "faults", "--scale", scale, "--journal", os.path.join(tmp, "faults.journal.json"),
                 *paths("faults"))
        wall, launches = drive(*fargs)
        with open(os.path.join(sweeps, "faults.json"), "rb") as f:
            first = f.read()
        resume_wall, resume_launches = drive(*fargs, "--resume")
        with open(os.path.join(sweeps, "faults.json"), "rb") as f:
            resumed = f.read()
        fl = json.loads(first)
        check(fl["backend"] == "numpy+torch", f"faults backend {fl['backend']}")
        fl = fl["faults"]
        n_units = len(GRIDS["faults"].workloads) * len(GRIDS["faults"].topologies) * len(GRIDS["faults"].fault_rates)
        check(len(fl["records"]) == n_units == 20 and fl["quarantined"] == {},
              f"{len(fl['records'])} of 20 units, quarantined: {sorted(fl['quarantined'])}")
        check(fl["backend_parity_max_rel"] <= fl["parity_rtol"], f"faults parity {fl['backend_parity_max_rel']}")
        check(all(r["backend_parity_rel"] == 0.0 for r in fl["records"] if r["fault_rate"] == 0.0),
              "the open arm at rate 0 is not bit-equal")
        check(all(finite(r[s].values()) for r in fl["records"] for s in ("proposed", "baseline")),
              "non-finite faults record")
        check(all(row["batch_parity"] for row in fl["repair"]), "repair_batch differs from the serial repair")
        check(launches > 0, "the faults grid launched segment_spmm no time")
        check(resumed == first, "the resumed faults artifact differs")
        check(resume_launches == 0, "the resumed faults run traced again")
        out["faults"] = {
            "wall_s": wall, "units": len(fl["records"]), "quarantined": len(fl["quarantined"]),
            "parity_max_rel": fl["backend_parity_max_rel"], "repair_rows": len(fl["repair"]),
            "min_win_at_10pct": min(r["win"] for r in fl["records"] if r["fault_rate"] == 0.10),
            "segment_spmm_launches": launches, "ell_spmm_launches": 0,
            "resume_wall_s": resume_wall, "resume_byte_identical": True,
        }

        # 3. paper at its own scale: the port's report, §Backpressure and §Resilience folded in
        md, js = os.path.join(tmp, "EXPERIMENTS.md"), os.path.join(tmp, "BENCH_sweep.json")
        wall, launches = drive("--grid", "paper", "--md", md, "--json", js, *paths("paper"))
        with open(md) as f:
            text = f.read()
        with open(js) as f:
            paper = json.load(f)
        check(all(f"## §{s}" in text for s in ("Calibration", "Perf", "Backpressure", "Resilience")),
              "the paper report lacks a section")
        check(launches == _pagerank_iterations(paper["records"]) > 0,
              f"paper: {launches} segment_spmm launches, not one a PageRank iteration")

        # 4. the freshness audit on those outputs
        issues = report.experiments_md_issues(md, js, sweeps)
        check(issues == [] and report.main(["--check", "--md", md, "--json", js, "--sweeps-dir", sweeps]) == 0,
              f"--check: {issues}")

    # 5. the paper records against the reference's committed numpy run
    with open(COMMITTED_BENCH) as f:
        bench = json.load(f)
    keys_equal = [r["key"] for r in paper["records"]] == [r["key"] for r in bench["records"]]
    differing = [(a["key"], k) for a, b in zip(paper["records"], bench["records"])
                 for k in sorted(set(a) | set(b)) if k != "elapsed_us" and a.get(k) != b.get(k)]
    equal = keys_equal and paper["grid"] == bench["grid"] and not differing
    out["paper"] = {
        "wall_s": wall, "timings": paper["timings"], "records": len(paper["records"]),
        "scale": paper["grid"]["scale"], "placement_stats": paper["placement_stats"],
        "segment_spmm_launches": launches, "ell_spmm_launches": 0,
    }
    out.update(check_issues=issues, paper_records_equal_committed=equal, paper_fields_differing=differing[:20],
               card=smi,
               timing="wall_s: host clock around run_main, closed by a device synchronise; timings: the "
                      "payload's own stage split (obs spans); each grid with a cold cache of its own")
    say("cli", **out)
    check(equal, f"paper records differ from the committed BENCH_sweep.json: {differing[:20]}")
    total = sum(out[g]["segment_spmm_launches"] for g in ("backpressure", "faults", "paper"))
    return out, total


# --------------------------------------------------------------------------- MoE serving

# olmoe-1b-7b at its published width and depth through the serve path, with the serve phase's traffic; then
# qwen2-moe-a2.7b at its published width over 4 of its 24 layers (at full depth its float32 master and bf16
# copy, 57.3 + 28.6 GB, do not fit on the card), one prompt of 2048 tokens and 8 decode steps
MOE_ARCH = "olmoe-1b-7b"
MOE_WIDE_ARCH, MOE_WIDE_LAYERS = "qwen2-moe-a2.7b", 4
MOE_WIDE_PROMPT, MOE_WIDE_STEPS = 2048, 8
# moe_block against moe_loop_ref on one layer at full width in float32: the same slots kept, outputs through
# float32 products of width 2048 (and 1024 back) in other shapes (one (E, C, D) bmm against an expert's rows
# at a time), each free to take another cuBLAS algorithm; tests/test_torch_moe.py's 1e-5 (at widths <= 128)
# is reported beside
MOE_LOOP_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TEST_TOL = dict(rtol=1e-5, atol=1e-5)


def moe_layer_input(run, layer: int) -> tuple[dict, torch.Tensor]:
    """(weights, input) of the MoE block of layer `layer` during `run()`: the
    transformer's reference to `models.moe` is swapped for the call, so the
    block itself runs as it is."""
    import types

    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm

    seen = []

    def grab(m, lp, x):
        if len(seen) <= layer:
            seen.append((lp, x.clone()) if len(seen) == layer else None)
        return moe_lib.moe_block(m, lp, x)

    tfm.moe_lib = types.SimpleNamespace(moe_block=grab)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        tfm.moe_lib = moe_lib
    return seen[layer]


def moe_loop_check(m, lp: dict, x: torch.Tensor) -> dict:
    """`moe_block` against `moe_loop_ref` on one layer's weights and input:
    the kept slots equal, the outputs within MOE_LOOP_TOL, two runs bit-equal."""
    from repro_torch.models import moe as moe_lib

    got, again = moe_lib.moe_block(m, lp, x), moe_lib.moe_block(m, lp, x)
    want, kept = moe_lib.moe_loop_ref(m, lp, x)
    _, top_i, _ = moe_lib._router(m, lp, x.reshape(-1, x.shape[-1]))
    plan = moe_lib._plan(m, top_i)
    kept_sort = torch.zeros_like(kept.view(-1)).index_copy_(0, plan.order, plan.keep).view(kept.shape)
    torch.cuda.synchronize()
    out = {"dtype": str(x.dtype).split(".")[-1], "tokens": x.shape[0] * x.shape[1], "C": plan.C,
           "kept_slots_equal": bool(torch.equal(kept, kept_sort)), "slots_dropped": int((~kept).sum()),
           "max_abs_err": float((got - want).abs().max()), "out_max_abs": float(want.abs().max()),
           "within_tolerance": bool(torch.allclose(got, want, **MOE_LOOP_TOL)), "tolerance": MOE_LOOP_TOL,
           "within_test_tolerance": bool(torch.allclose(got, want, **MOE_TEST_TOL)),
           "bit_equal_two_runs": bool(torch.equal(got, again))}
    check(out["kept_slots_equal"], f"moe_block and moe_loop_ref keep other slots: {out}")
    check(out["within_tolerance"], f"moe_block vs moe_loop_ref: {out}")
    check(out["bit_equal_two_runs"], "two runs of moe_block differ")
    return out


def moe_routes(calls: list, m, n_layers: int) -> dict:
    """From `drain_timed`'s route logs (a list of routings a call, one a
    layer): each call's C, tokens and share of routed slots dropped, the
    experts that got a slot (summed over layers, mean over calls), and the
    expert load skew (max/mean of the slots an expert got) of each layer over
    all calls."""
    per_call, total = [], torch.zeros((n_layers, m.num_experts), dtype=torch.long)
    hit = 0.0
    for routings in calls:
        check(len(routings) == n_layers, f"{len(routings)} routings in a call of {n_layers} layers")
        C = routings[0][0]
        counts = torch.stack([c for _, c in routings]).cpu()  # (L, E)
        slots = int(counts[0].sum())
        per_call.append({"C": C, "tokens": slots // m.top_k,
                         "dropped_share": int((counts - C).clamp_min(0).sum()) / (slots * n_layers)})
        hit += int((counts > 0).sum()) / len(calls)
        total += counts
    skew = total.max(1).values.float() / (total.sum(1).float() / m.num_experts)
    return {"calls": per_call, "experts_hit_a_call": hit, "skew_by_layer": [round(float(s), 4) for s in skew],
            "skew_max": float(skew.max())}


def moe_decode_bytes(cfg, experts_hit: float, pos: np.ndarray) -> dict:
    """Bytes one decode step of `len(pos)` slots must move (bf16 weights, the
    float32 router, cache rows read up to each slot's position and written
    at it, logits out) over the memory rate: with every expert's weights
    read, as the dense (E, C, D) product does, and with only the
    `experts_hit` experts (summed over layers) that got a slot."""
    m, d, L, dh = cfg.moe, cfg.d_model, cfg.n_layers, cfg.head_dim
    b = len(pos)
    expert = 3 * d * m.d_ff_expert * 2
    other = L * (d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * d) * 2  # attention weights
    other += L * (3 * d * m.d_ff_shared + (d if m.d_ff_shared else 0)) * 2  # shared expert and its gate
    other += L * d * m.num_experts * 4 + (2 * L + 1) * d * 2 + d * cfg.vocab * 2  # router, norms, head
    other += b * d * 2 + b * cfg.vocab * 2  # embedding rows in, logits out
    other += 2 * L * cfg.n_kv_heads * dh * 4 * (int((pos + 1).sum()) + b)  # float32 cache: read, write
    dense, hit = L * m.num_experts * expert, experts_hit * expert
    return {"expert_bytes_dense": dense, "expert_bytes_hit": hit, "other_bytes": other,
            "bound_ms_dense": (dense + other) / H100_BYTES_PER_S * 1e3,
            "bound_ms_hit_only": (hit + other) / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def moe_split(m, lp: dict, x: torch.Tensor, attention, timer: Timer, n_layers: int, total_ms: float) -> dict:
    """Device ms of one call by part, each part replayed alone from a CUDA
    graph on one layer's weights and input and counted once a layer: router
    and top-k, dispatch (sort and scatter), expert products, combine, the
    shared expert, attention (`attention()`); the rest is `total_ms` (the
    whole call's device time, from `torch.profiler`) less those."""
    from repro_torch.models import moe as moe_lib

    flat = x.reshape(-1, x.shape[-1])
    top_p, top_i, _ = moe_lib._router(m, lp, flat)
    plan = moe_lib._plan(m, top_i)
    buf = moe_lib._dispatch(m, plan, flat)
    y = moe_lib._expert_ffn(lp["we_gate"], lp["we_up"], lp["we_down"], buf)
    parts = {
        "router_topk_ms": lambda: moe_lib._router(m, lp, flat),
        "dispatch_ms": lambda: moe_lib._dispatch(m, moe_lib._plan(m, top_i), flat),
        "experts_ms": lambda: moe_lib._expert_ffn(lp["we_gate"], lp["we_up"], lp["we_down"], buf),
        "combine_ms": lambda: moe_lib._combine(m, plan, y, top_p),
        "attention_ms": attention,
    }
    if m.d_ff_shared:
        parts["shared_expert_ms"] = lambda: moe_lib._shared_expert(lp, x)
    out = {k: timer.device_ms(fn, calls=5, reps=10) * n_layers for k, fn in parts.items()}
    out["total_ms"] = total_ms
    out["rest_ms"] = total_ms - sum(out[k] for k in parts) if total_ms > 0 else "not measured"
    return out


def moe_serve(cfg, device: torch.device, seed: int, prompts: list, new_tokens: int, timer: Timer) -> dict:
    """One MoE model through `build_engine` (4 slots, max_seq 4096, float32
    cache): the drain and its checks, the logit checks, `moe_block` against
    `moe_loop_ref` on the middle layer in float32, two bf16 prefills
    bit-equal, routing statistics, the device split of a prefill and of a
    decode step, the decode step's byte bound."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import gqa_attention

    m, L = cfg.moe, cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = tfm.init_params(cfg, seed, device=device)  # a seeded torch.Generator on the card
    params = tfm.cast_params(params32, cfg)  # bf16 weights, the router kept in float32
    engine = build_engine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(params["layers"]["router"].dtype == torch.float32 and params["layers"]["we_gate"].dtype == torch.bfloat16,
          "the served weights: bf16 experts, float32 router")

    prefill_one, decode = engine.prefill_one, engine.decode
    engine.cache, _ = prefill_one(engine.cache, 0, torch.from_numpy(prompts[0][None, :256].astype(np.int64)))
    _, engine.cache = decode(engine.cache, torch.zeros((SERVE_SLOTS, 1), dtype=torch.long),
                             torch.zeros(SERVE_SLOTS, dtype=torch.long))
    torch.cuda.synchronize()

    logs = {"prefill": [], "decode": []}
    done, st, wall_s, launches = drain_timed(engine, prompts, new_tokens, logs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} requests drained")
    for r in done:
        check(len(r.out_tokens) == new_tokens or r.out_tokens[-1] == engine.eos_id,
              f"request {r.uid}: {len(r.out_tokens)} tokens")
    check(launches == L * len(prompts), f"flash_attention launched {launches} times, want {L} a prefill × "
          f"{len(prompts)}")
    check(st["finite"], "non-finite logits")
    prefill_routes, decode_routes = moe_routes(logs["prefill"], m, L), moe_routes(logs["decode"], m, L)
    check(all(c["dropped_share"] == 0 for c in decode_routes["calls"]), "a decode step dropped a slot")

    toks = torch.from_numpy(prompts[0][None, :].astype(np.int64)).to(device)
    n, layer = toks.shape[1], L // 2
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def one_prefill(c, prm):
        cache = tfm.init_kv_cache(c, 1, n, dtype=torch.float32, device=device)
        return tfm.prefill(prm, toks, cache, c)[0], cache

    loop_f32 = moe_loop_check(m, *moe_layer_input(lambda: one_prefill(cfg32, params32), layer))
    checks = logit_checks(cfg, params32, params, toks, device)
    checks["first_token_engine"] = done[[r.uid for r in done].index(0)].out_tokens[0]
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    (la, ca), (lb, cb) = one_prefill(cfg, params), one_prefill(cfg, params)
    bit_equal = bool(torch.equal(la, lb) and torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"]))
    check(bit_equal, "two bf16 prefills of one prompt differ")
    del ca, cb

    # where the time goes: request 0's prompt in slot 0, and decode steps at the drained engine's positions
    lp, x = moe_layer_input(lambda: one_prefill(cfg, params), layer)
    prof_prefill = profile_window(lambda: prefill_one(engine.cache, 0, toks))
    q = torch.randn((1, n, cfg.n_heads, cfg.head_dim), device=device).bfloat16()
    kv = torch.randn((1, n, cfg.n_kv_heads, cfg.head_dim), device=device).bfloat16()
    split_prefill = moe_split(m, lp, x, lambda: causal_attention(q, kv, kv), timer, L, prof_prefill["device_ms"])
    pos = torch.from_numpy(engine.pos.astype(np.int64)).to(device)
    step_tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=device)
    lpd, xd = moe_layer_input(lambda: decode(engine.cache, step_tokens, pos), layer)

    def eight_steps():
        for _ in range(8):
            decode(engine.cache, step_tokens, pos)

    prof_decode = profile_window(eight_steps)
    qd = torch.randn((SERVE_SLOTS, 1, cfg.n_heads, cfg.head_dim), device=device).bfloat16()
    ck, cv = engine.cache["k"][0], engine.cache["v"][0]
    split_decode = moe_split(m, lpd, xd, lambda: gqa_attention(qd, ck, cv, causal=False, kv_valid_len=pos + 1),
                             timer, L, prof_decode["device_ms"] / 8)
    decode_bytes = moe_decode_bytes(cfg, decode_routes["experts_hit_a_call"], engine.pos)
    decode_routes = {k: v for k, v in decode_routes.items() if k != "calls"} | {
        "C": sorted({c["C"] for c in decode_routes["calls"]}),
        "dropped_share_max": max(c["dropped_share"] for c in decode_routes["calls"])}
    del engine, params, lp, x, lpd, xd
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab, "experts": m.num_experts, "top_k": m.top_k,
        "d_ff_expert": m.d_ff_expert, "d_ff_shared": m.d_ff_shared, "norm_topk": m.norm_topk,
        "capacity_factor": m.capacity_factor, "impl": m.impl, "params": cfg.num_params,
        "active_params": cfg.num_active_params, "activations": "bfloat16", "slots": SERVE_SLOTS,
        "max_seq": SERVE_MAX_SEQ, "kv_cache": "float32", "requests": len(prompts),
        "prompt_lengths": [len(p) for p in prompts], "max_new_tokens": new_tokens,
        "new_tokens": [len(r.out_tokens) for r in sorted(done, key=lambda r: r.uid)],
        "setup_s": setup_s, "wall_s": wall_s, "prefill_s": st["prefill_s"], "prefill_tokens": st["prefill_tokens"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"], "decode_steps": st["decode_steps"],
        "decode_ms_a_step": st["decode_s"] / st["decode_steps"] * 1e3,
        "decode_tok_s": st["decode_tokens"] / st["decode_s"], "flash_attention_launches": launches,
        "max_memory_allocated_gb": peak_gb, "logit_checks": checks, "moe_vs_loop_f32": loop_f32,
        "prefills_bit_equal": bit_equal, "routes_prefill": prefill_routes, "routes_decode": decode_routes,
        "split_prefill_ms": split_prefill, "split_decode_step_ms": split_decode, "decode_bytes": decode_bytes,
        "profile_prefill": prof_prefill, "profile_8_decode_steps": prof_decode,
    }


def causal_attention(q, k, v):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    return flash_attention(q, k, v, causal=True)


def phase_moe(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """The attention kernel at olmoe's prefill shape against its plain
    version; olmoe-1b-7b, then qwen2-moe-a2.7b cut to 4 layers, through
    `moe_serve`.  Returns (the `moe` line, the attention check)."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    cfg = get_arch(MOE_ARCH).model_config()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)  # the serve phase's traffic
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]

    # the attention kernel at olmoe's prefill shape (group 1: 16 query and 16 kv heads), the longest prompt
    s = int(lengths.max())
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, cfg.n_heads, cfg.head_dim)).astype(np.float32))
               .to(device).bfloat16() for _ in range(3))
    got, again = causal_attention(q, k, v), causal_attention(q, k, v)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, again), "two runs of the attention kernel differ at olmoe's shape")
    check(torch.allclose(got.float(), want.float(), **BF16_TOL), f"attention kernel vs plain at olmoe's shape: {err}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound_ms, bound_by = attention_bound_ms(q, k, True, 0)
    attn = {"shape": f"olmoe-1b-7b prefill attention: q/k/v (1, {s}, {cfg.n_heads}, {cfg.head_dim}) bf16, causal",
            "max_abs_err": err,
            "tolerance": BF16_TOL, "bit_equal_two_runs": True,
            "ms": timer.device_ms(lambda: causal_attention(q, k, v)),
            "plain_ms": timer.call_ms(lambda: flash_attention_ref(q, k, v, causal=True), calls=3, reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timer.call_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))}
    del q, k, v, qt, kt, vt, got, again, want

    olmoe = moe_serve(cfg, device, seed, prompts, SERVE_NEW, timer)
    wide = dataclasses.replace(get_arch(MOE_WIDE_ARCH).model_config(), n_layers=MOE_WIDE_LAYERS)
    wide_prompt = [rng.integers(2, wide.vocab, size=MOE_WIDE_PROMPT).astype(np.int32)]
    qwen = moe_serve(wide, device, seed, wide_prompt, MOE_WIDE_STEPS + 1, timer)
    out = {"olmoe": olmoe | {"cuts": []},
           "qwen": qwen | {"cuts": [f"{MOE_WIDE_LAYERS} of {get_arch(MOE_WIDE_ARCH).n_layers} layers: at full "
                                    "depth the float32 master (57.3 GB) and bf16 copy (28.6 GB) exceed the card"]},
           "attention_at_olmoe_shape": attn,
           "weights": "random, from a seeded torch.Generator on the card; a bf16 served copy of a float32 master",
           "timing": "host clock around each prefill / decode call, synchronised on both sides; profiles with "
                     "torch.profiler after the drain; split parts replayed alone from a CUDA graph (device time) "
                     "on the middle layer's weights and input, counted once a layer",
           "card": smi}
    say("moe", **out)
    return out, attn


# --------------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.device import probe
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.graph.generators import table2_workloads
    from repro_torch.kernels.build import build_library

    device = torch.device("cuda")
    scale = 1.0
    t_all = time.perf_counter()
    info = probe()
    say("probe", **info)

    t0 = time.perf_counter()
    sources = {"ell_spmm": KERNEL_SOURCE, "flash_attention": FA_SOURCE, "flash_attention_bwd": FA_BWD_SOURCE,
               "embedding_bag": BAG_SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a source, all at once
        libs = dict(zip(sources, pool.map(build_library, sources)))
    say("build", sources=list(sources.values()), libraries=[p.name for p in libs.values()],
        seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    graph = table2_workloads(scale=scale, seed=args.seed, names=("amazon",))["amazon"]
    small = table2_workloads(scale=scale * 0.05, seed=args.seed, names=("amazon",))["amazon"]
    say("graph", workload="amazon", scale=scale, nodes=graph.num_nodes, edges=graph.num_edges,
        host_seconds=time.perf_counter() - t0)

    timer = Timer()
    kern = phase_kernels(device, graph, timer)
    phase_engine(device, graph, small)
    grid = dataclasses.replace(GRIDS["paper"], name="paper-amazon", workloads=("amazon",),
                               scale=scale, seed=args.seed)
    _, launches = phase_sweep(device, grid, graph, info["nvidia_smi"])
    cgrid = dataclasses.replace(GRIDS["backpressure"], name="backpressure-amazon", workloads=("amazon",),
                                scale=scale, seed=args.seed)
    _, noc_launches = phase_contention(device, cgrid, graph, info["nvidia_smi"])
    fgrid = dataclasses.replace(GRIDS["faults"], name="faults-amazon", workloads=("amazon",),
                                scale=scale, seed=args.seed)
    _, faults_launches = phase_faults(device, fgrid, graph, info["nvidia_smi"])
    gnn, gnn_launches = phase_gnn(device, graph, args.seed, info["nvidia_smi"], timer)
    del graph, small
    _, cli_launches = phase_cli(info["nvidia_smi"])
    torch.cuda.empty_cache()
    attn = phase_attention(device, timer)
    _, fa_launches = phase_serve(device, args.seed, info["nvidia_smi"])
    torch.cuda.empty_cache()
    _, train_launches = phase_train(device, args.seed, info["nvidia_smi"], timer)
    bag = phase_bag(device, args.seed, timer)
    _, bag_launches = phase_recsys(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_attn = phase_moe(device, args.seed, info["nvidia_smi"], timer)
    say("done", seconds=time.perf_counter() - t_all)

    print(json.dumps({"kernels": [{
        "name": "ell_spmm", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "launches_contention": noc_launches, "launches_faults": faults_launches,
        "launches_cli": cli_launches,
        "max_abs_err": max(kern["max_abs_err_f32"], kern["real_bucket_max_abs_err"]),
        "max_abs_err_bf16": kern["max_abs_err_bf16"],
        "ms": kern["kernel_ms"], "call_ms": kern["kernel_call_ms"], "plain_ms": kern["ref_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "library_device_ms": kern["library_device_ms"], "per_bucket_reduce_ms": kern["per_bucket_reduce_ms"],
        "launches_per_reduce": kern["launches_per_reduce"], "entry": "segment_spmm_launch (every bucket, one launch)",
        "shape": "one PageRank reduce on amazon (every ELL bucket, PageRank weights) at D=1",
        "launches_gnn": gnn_launches, "launches_train": train_launches["segment_spmm"],
        "gin_transpose": {"shape": f"the transposed reduce of gin-tu's backward on amazon (ELL of the unreversed "
                                   f"edges, weights 1) at D={gnn['amazon']['train']['transpose_reduce']['D']}, f32",
                          **{k: gnn["amazon"]["train"]["transpose_reduce"][k] for k in (
                              "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "library_device_ms", "max_abs_err_vs_library", "max_abs_err_vs_plain")}},
        "gin": {"shape": f"GIN's neighbour sum on amazon ({gnn['amazon']['nodes']:,} nodes, "
                         f"{gnn['amazon']['edges']:,} edges, ELL of the reversed edges, weights 1), f32",
                **{k: {f: r[f] for f in ("D", "ms", "call_ms", "no_hub_ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_device_ms", "scatter_ms", "max_abs_err_vs_plain",
                                         "max_abs_err_vs_library", "max_abs_err_vs_scatter")}
                   for k, r in gnn["amazon"]["reduce"].items()}},
    }, {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": fa_launches,
        "max_abs_err": max(attn["max_abs_err_f32"], attn["max_abs_err_bf16"], attn["path_max_abs_err"]),
        "max_abs_err_f32": attn["max_abs_err_f32"],
        "ms": attn["kernel_ms"], "call_ms": attn["kernel_call_ms"], "plain_ms": attn["ref_ms"],
        "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
        "library_device_ms": attn["library_device_ms"], "achieved_tflops": attn["achieved_tflops"],
        "shape": f"llama3.2-3b prefill attention: q (1, {ATTN_TIMED_S}, 24, 128), k/v (1, {ATTN_TIMED_S}, 8, 128) "
                 "bf16, causal",
        "launches_train": train_launches["flash_attention"],
        "launches_moe": moe["olmoe"]["flash_attention_launches"],
        "launches_moe_qwen": moe["qwen"]["flash_attention_launches"],
        "moe_shape": moe_attn,
    }, {
        "name": "flash_attention_bwd", "route": "cuda", "source": FA_BWD_SOURCE,
        "replaces": FA_REPLACES + " (its gradient: the TPU kernel has none; the reference differentiates "
                    "its attention by autodiff)",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": attn["backward"]["max_abs_err"],
        "max_rel_err_f32": attn["backward"]["max_rel_err_f32"], "max_rel_err_bf16": attn["backward"]["max_rel_err_bf16"],
        **{k: attn["backward"]["timed"]["train"][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                              "library_ms", "tflops", "kernels_ms")},
        "shape": "llama3.2-3b training attention: q (8, 128, 24, 128), k/v (8, 128, 8, 128) bf16, causal; "
                 "library: the backward of scaled_dot_product_attention",
        "kernel_route": attn["backward"]["route_bf16"],
        "kernel_resources": attn["backward"]["kernel_resources"],
        "serve_shape": {k: attn["backward"]["timed"]["serve"][k] for k in (
            "q", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops", "kernels_ms")},
    }, {
        "name": "embedding_bag", "route": "cuda", "source": BAG_SOURCE, "replaces": BAG_REPLACES,
        "launches": bag_launches,
        "max_abs_err": max(bag["max_abs_err_f32"], bag["path_max_abs_err"], bag["grad_max_abs_err"]),
        "max_abs_err_bf16": bag["max_abs_err_bf16"],
        **{k: bag["path"]["single_hot"][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")},
        "shape": f"dcn-v2 lookup: tables (26, 1000000, 16) f32, ids ({BAG_PATH_BATCH}, 26, 1) Zipf(1.1), "
                 "no weights",
        "multi_hot_weighted": {k: bag["path"]["multi_hot_weighted"][k] for k in (
            "B", "L", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }]}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
