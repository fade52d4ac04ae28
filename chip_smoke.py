#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The path is the paper pipeline of `repro_torch` (R-MAT graph → vertex-program
trace → partition → traffic → stacked placement search → stacked analytic
simulator) on the Table-2 workload `amazon` at its published size (304,000
nodes, 4,300,000 edges), on the `paper` grid's 12 configurations for it
(bfs/sssp/pagerank × mesh2d/fbutterfly × proposed vs randomized baseline, 16
engines).  Phases, one JSON line each:

  probe    the card and the toolchain
  build    `nvcc` on `src/repro_torch/csrc/ell_spmm.cu`
  kernels  the CUDA kernel against its plain PyTorch version (test shapes,
           every real ELL bucket of the full-size graph, two runs bit-equal)
           and its time beside the byte bound and `torch.sparse.mm`
  engine   `run_traced` for the three algorithms against host references
  sweep    `run_sweep` with the torch backend against the numpy backend

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

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

TEST_SHAPES = [(50, 16, 8), (100, 7, 3), (30, 4, 16), (64, 32, 1)]  # (N, R, W)
TEST_DIMS = [1, 16, 64, 128, 256]
F32_TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of an fp32 sum
KERNEL_SOURCE = "src/repro_torch/csrc/ell_spmm.cu"
KERNEL_REPLACES = "src/repro/kernels/segment_spmm/kernel.py:51"


def say(phase: str, **fields) -> None:
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


def phase_kernels(device: torch.device, graph, timer: Timer) -> dict:
    from repro_torch.graph.algorithms import prepare_graph
    from repro_torch.graph.structs import build_ell
    from repro_torch.kernels.segment_spmm.ops import ell_spmm
    from repro_torch.kernels.segment_spmm.ref import ell_spmm_ref

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
    tot_bound_ms = 0.0
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
        k_ms = timer.device_ms(lambda: ell_spmm(x, cols, wts))
        c_ms = timer.call_ms(lambda: ell_spmm(x, cols, wts))
        r_ms = timer.call_ms(lambda: ell_spmm_ref(x, cols, wts), calls=5, reps=5)
        bound, _ = bucket_bound_ms(x, cols, wts)
        tot_bound_ms += bound
        buckets.append({"W": ell.widths[b], "R": int(cols.shape[0]), "ms": k_ms, "call_ms": c_ms,
                        "plain_ms": r_ms, "bound_ms": bound, "max_abs_err": err})

    def one_reduce():
        for b in range(ell.num_buckets):
            if ell.cols[b].shape[0]:
                ell_spmm(x, ell.cols[b], ell.weights[b])

    def one_reduce_plain():
        for b in range(ell.num_buckets):
            if ell.cols[b].shape[0]:
                ell_spmm_ref(x, ell.cols[b], ell.weights[b])

    # one reduce = every real bucket in sequence, as the engine runs them: the
    # buckets' cols/wts together exceed the L2, so this is slower than the sum
    # of the buckets timed alone (the `buckets` list), and it is the time kept
    launches_before_timing = ell_spmm.launches
    reduce_ms = timer.device_ms(one_reduce, calls=5)
    reduce_call_ms = timer.call_ms(one_reduce, calls=5)
    reduce_plain_ms = timer.call_ms(one_reduce_plain, calls=3, reps=5)
    check(ell_spmm.launches > launches_before_timing, "timed calls must launch")
    all_cols = torch.cat([c.reshape(-1) for c in ell.cols])
    real_entries = int(((all_cols >= 0) & (all_cols < n)).sum())
    ops_ms = 2.0 * real_entries / H100_F32_FLOPS * 1e3
    bound_ms = max(tot_bound_ms, ops_ms)
    bound_by = "bytes" if tot_bound_ms >= ops_ms else "operations"

    # yardstick: one library call computing the same function (used nowhere in the port)
    idx = torch.from_numpy(np.stack([pg.dst, pg.src]).astype(np.int64)).to(device)
    val = torch.from_numpy(pg.weight.astype(np.float32)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a_csr = torch.sparse_coo_tensor(idx, val, (n, n)).coalesce().to_sparse_csr()
    lib = torch.sparse.mm(a_csr, x)
    whole = torch.zeros((n + 1, 1), dtype=torch.float32, device=device)
    for b in range(ell.num_buckets):
        if ell.cols[b].shape[0]:
            whole[ell.rows[b].long().clamp(max=n)] = ell_spmm(x, ell.cols[b], ell.weights[b])
    torch.cuda.synchronize()
    lib_err = float((whole[:n] - lib).abs().max())
    check(torch.allclose(whole[:n], lib, **F32_TOL), f"all buckets vs torch.sparse.mm: {lib_err}")
    library_ms = timer.call_ms(lambda: torch.sparse.mm(a_csr, x))

    out = {
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL, "bit_equal_two_runs": True,
        "graph": {"nodes": n, "edges": graph.num_edges, "ell_fill": ell.fill_fraction(),
                  "real_entries": real_entries, "D": 1},
        "buckets": buckets, "real_bucket_max_abs_err": real_err,
        "kernel_ms": reduce_ms, "kernel_call_ms": reduce_call_ms, "ref_ms": reduce_plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "timing": "warm medians with CUDA events. kernel_ms: one PageRank reduce, every real bucket "
                  "in sequence, replayed from a CUDA graph (device time alone); kernel_call_ms, "
                  "ref_ms, library_ms: the same reduce enqueued from Python (host enqueue cost "
                  "included); buckets[]: each bucket alone, its cols/wts warm in the L2",
    }
    say("kernels", **out)
    return out


# --------------------------------------------------------------------------- engine


def phase_engine(device: torch.device, graph, small_graph) -> dict:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.vertex_program import run_traced
    from repro_torch.kernels.segment_spmm.ops import ell_spmm

    out: dict = {}

    def traced(name, g, **kw):
        """(trace, seconds of the iteration loop, seconds of set-up).  Two
        iterations run first and are thrown away, so that the timed loop pays
        no first-use cost (CUDA loads an operator's kernels at its first call)."""
        t: dict = {}
        prepared, program = alg.prepare_graph(name, g), alg.ALGORITHMS[name]()
        run_traced(prepared, program, max_iterations=2, device=device, **kw)
        t["launches_before"] = ell_spmm.launches
        tr = run_traced(prepared, program, max_iterations=40 if name == "pagerank" else 200,
                        device=device, timings=t, **kw)
        traced.launches = ell_spmm.launches - t["launches_before"]
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
    check(launches > 0, "pagerank did not launch ell_spmm")
    tr_sc, secs_sc, prep_sc = traced("pagerank", graph, reduce_impl="scatter")
    ref = alg.reference_pagerank(alg.prepare_graph("pagerank", graph))
    rel = float(np.max(np.abs(tr_ell.props - tr_sc.props) / np.abs(tr_sc.props)))
    check(rel <= 2e-3, f"pagerank ell vs scatter: max relative error {rel}")
    l1 = float(np.abs(tr_ell.props.astype(np.float64) - ref).sum())
    check(np.allclose(tr_ell.props, ref, atol=1e-4) and l1 <= 1e-3, f"pagerank vs reference: L1 {l1}")
    check(abs(float(tr_ell.props.sum()) - float(tr_sc.props.sum())) < 1e-3, "pagerank mass")
    out["pagerank"] = {
        "iterations_ell": tr_ell.num_iterations, "iterations_scatter": tr_sc.num_iterations,
        "s_per_iteration_ell": secs_ell / tr_ell.num_iterations,
        "s_per_iteration_scatter": secs_sc / tr_sc.num_iterations,
        "prepare_s_ell": prep_ell, "prepare_s_scatter": prep_sc,
        "ell_spmm_launches": launches, "max_rel_err_ell_vs_scatter": rel, "l1_vs_reference": l1,
        "edge_activity_equal": bool(np.array_equal(tr_ell.edge_activity, tr_sc.edge_activity)),
    }
    say("engine", **out)
    return out


# --------------------------------------------------------------------------- sweep


def phase_sweep(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    from repro_torch.experiments.batched import simulate_batch
    from repro_torch.experiments.placement_batch import place_batch
    from repro_torch.experiments.sweep import figure_comparisons, run_sweep
    from repro_torch.kernels.segment_spmm.ops import ell_spmm

    ell_spmm.launches = 0  # the main path's own count starts here
    torch.cuda.synchronize()
    res = run_sweep(grid, backend="torch", device=device, measure_serial=True,
                    graphs={"amazon": graph}, keep_artifacts=True)
    torch.cuda.synchronize()
    launches = ell_spmm.launches
    check(launches > 0, "run_sweep launched ell_spmm no time")
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
        "ell_spmm_launches": launches, "card": smi,
    }
    say("sweep", **out)
    return out, launches


# --------------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    from repro_torch.device import probe
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.graph.generators import table2_workloads

    from repro_torch.kernels.segment_spmm import kernel

    device = torch.device("cuda")
    scale = 1.0
    t_all = time.perf_counter()
    info = probe()
    say("probe", **info)

    t0 = time.perf_counter()
    lib = kernel.build()
    say("build", source=KERNEL_SOURCE, library=lib.name, seconds=time.perf_counter() - t0)

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
    say("done", seconds=time.perf_counter() - t_all)

    print(json.dumps({"kernels": [{
        "name": "ell_spmm", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(kern["max_abs_err_f32"], kern["real_bucket_max_abs_err"]),
        "max_abs_err_bf16": kern["max_abs_err_bf16"],
        "ms": kern["kernel_ms"], "call_ms": kern["kernel_call_ms"], "plain_ms": kern["ref_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "shape": "every real ELL bucket of amazon (PageRank weights) at D=1, one reduce in sequence",
    }]}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
