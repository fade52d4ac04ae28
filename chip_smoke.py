#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Three paths, each driven with its kernel's launch count set to 0 just before
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
* recsys: dcn-v2 at its published configuration (26 tables × 1,000,000 × 16,
  cross 3 × 429², MLP 1024-1024-512: 418,569,930 float32 params from a seeded
  generator on the card) — the `RECSYS_SHAPES` cells `serve_p99` (batch 512),
  `serve_bulk` (262,144) and `retrieval_cand` (1 query, 1,000,000 candidates,
  top-100) through `models.recsys`, then `train_batch` (65,536) for 20 steps
  through `launch.train.train`, the code path of `python -m
  repro_torch.launch.train --arch dcn-v2 --batch 65536`; its kernel is
  `embedding_bag` (every forward and every training step).

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
  cli        the sweep CLI: backpressure, faults (then resumed: byte-identical,
             no trace) and paper, each with a cold cache of its own; wall time
             and stage split a grid, one `segment_spmm` launch a PageRank
             iteration, `--check` clean on the port's EXPERIMENTS.md and
             BENCH_sweep.json, the paper records equal to the committed ones
  attention  `flash_attention` against its plain version (test shapes, f32
             and bf16, and the serve path's shapes; two runs bit-equal), its
             time and TFLOP/s at every path shape beside the operation bound
             and `scaled_dot_product_attention` (call and CUDA-graph
             replay), and the bf16 kernel's registers and shared memory
  serve      the serve path, its throughput, and full-width logit checks
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

Every line carries `seconds`, the time since the line before it.

then the contract lines: one `{"kernels": [...]}` object, the card's name and
power limit as `nvidia-smi` prints them, and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Any failed check raises, so the script exits non-zero and prints no last
line.  Without a CUDA device it exits with code 2 at once; it never carries on
on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    out = {
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


def profile_window(fn) -> dict:
    """Device time by kernel over one call of `fn` (`torch.profiler`), summed
    over device rows only, beside the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key), reverse=True)
    total = sum(r[0] for r in rows) / 1e3
    attn = sum(r[0] for r in rows if "attn_bf16_wgmma" in r[1]) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": total, "device_busy_share": total / (wall * 1e3),
            "flash_attention_ms": attn,
            "top_kernels": [{"name": k[:80], "device_ms": us / 1e3, "calls": n} for us, k, n in rows[:8]]}


def phase_serve(device: torch.device, seed: int, smi: str | None) -> tuple[dict, int]:
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import gqa_attention
    from repro_torch.serve.engine import Request

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

    st = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_tokens": 0, "decode_tokens": 0, "decode_steps": 0,
          "finite": True}

    def timed_prefill(cache, slot, tokens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache, logits = prefill_one(cache, slot, tokens)
        torch.cuda.synchronize()
        st["prefill_s"] += time.perf_counter() - t
        st["prefill_tokens"] += int(tokens.shape[1])
        st["finite"] &= bool(torch.isfinite(logits).all())
        return cache, logits

    def timed_decode(cache, tokens, pos):
        live = sum(a is not None for a in engine.active)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = decode(cache, tokens, pos)
        torch.cuda.synchronize()
        st["decode_s"] += time.perf_counter() - t
        st["decode_tokens"] += live
        st["decode_steps"] += 1
        st["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    engine.prefill_one, engine.decode = timed_prefill, timed_decode
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW))
    flash_attention.launches = 0  # the serve path's own count starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == SERVE_REQUESTS, f"{len(done)} of {SERVE_REQUESTS} requests drained")
    for r in done:
        check(len(r.out_tokens) == SERVE_NEW or r.out_tokens[-1] == engine.eos_id,
              f"request {r.uid}: {len(r.out_tokens)} tokens")
    check(launches == cfg.n_layers * SERVE_REQUESTS, f"flash_attention launched {launches} times, "
          f"want {cfg.n_layers} a prefill × {SERVE_REQUESTS}")
    check(st["finite"], "non-finite logits")

    # full-width logit checks on request 0's prompt, each in a one-slot cache of its own
    toks = torch.from_numpy(prompts[0][None, :].astype(np.int64)).to(device)
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
        "first_token_engine": done[[r.uid for r in done].index(0)].out_tokens[0],
        "tolerance_f32": MODEL_TOL, "bf16_route_factor": BF16_ROUTE_FACTOR, "errors": "[max abs, mean abs]",
    }
    check(torch.allclose(k32, truth, **MODEL_TOL), f"f32 logits, kernel vs ref: {checks['f32_kernel_vs_ref']}")
    check(torch.allclose(d32, k32, **MODEL_TOL), f"f32 logits, decode vs prefill: {checks['f32_decode_vs_prefill']}")
    floor = checks["bf16_ref_vs_truth"][1]
    check(checks["bf16_kernel_vs_truth"][1] <= BF16_ROUTE_FACTOR * floor,
          f"bf16 logits, kernel route less accurate than the plain route: {checks}")
    check(checks["bf16_decode_vs_truth"][1] <= BF16_ROUTE_FACTOR * floor,
          f"bf16 logits, decode less accurate than the plain prefill: {checks}")
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
    sources = {"ell_spmm": KERNEL_SOURCE, "flash_attention": FA_SOURCE, "embedding_bag": BAG_SOURCE}
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
    del graph, small
    _, cli_launches = phase_cli(info["nvidia_smi"])
    torch.cuda.empty_cache()
    attn = phase_attention(device, timer)
    _, fa_launches = phase_serve(device, args.seed, info["nvidia_smi"])
    torch.cuda.empty_cache()
    bag = phase_bag(device, args.seed, timer)
    _, bag_launches = phase_recsys(device, args.seed, info["nvidia_smi"], timer)
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
