#!/usr/bin/env python3
"""GIN's neighbour sum on amazon at D = 64 and 100, with its hub rows and without them, on one GPU.

    python3 tools/gnn_reduce_hub.py [--src DIR] [--label NAME] [--dims 64,100]

The reduce is `segment_spmm` over the ELL of amazon's reversed edges without
weights (every weight 1: the ELL `models.gnn.batch_ell` builds for GIN;
`--dims` picks other widths, D = 1 being PageRank's), on
the Table-2 workload at its published size (304,000 nodes, 4,300,000 edges,
R-MAT seed 0).  For each D it times, as CUDA-graph replays (device time
alone, warm medians with CUDA events): the whole fused reduce; the same
launch with the hub items (rows of width ≥ 1,024) left out of the work
table; the hub items alone; and `torch.sparse.mm` with the adjacency in CSR
(the library call).  It checks the whole reduce against `segment_spmm_ref`
and `torch.sparse.mm`, and prints one JSON line with the bound (x, the real
cols and the output once, over the memory rate) and the card's name and
power limit.

`--src` names the `src` directory whose `repro_torch` is imported (default:
this checkout's), so that one call can time another checkout's kernel beside
this one's: each builds its own kernel into its own `build/`.  Needs a CUDA
device; a run without one fails.
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

ROOT = pathlib.Path(__file__).resolve().parents[1]

H100_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
TOL = dict(rtol=2e-3, atol=2e-4)  # fp32 sums of up to 23,552 terms of N(0, 1), in another order
HUB_WIDTH = 1024  # graph/structs.py ELL_HUB_WIDTH: a row this wide is an item of its own


def replay_ms(fn, calls: int = 10, reps: int = 15) -> float:
    """Median device time of one call: `calls` calls captured into a CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--dims", default="64,100", help="feature widths, comma-separated")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gnn_reduce_hub: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    from repro_torch.device import smi_name_and_power_limit
    from repro_torch.graph.generators import table2_workloads
    from repro_torch.graph.structs import EllWork, HostGraph, build_ell
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = table2_workloads(scale=1.0, seed=0, names=("amazon",))["amazon"]
    t_graph = time.perf_counter() - t0
    n = g.num_nodes
    t0 = time.perf_counter()
    ell = build_ell(HostGraph(n, g.dst, g.src), device=dev)
    work = ell.work()
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    hub = work.items[:, 2] >= HUB_WIDTH
    no_hub = dataclasses.replace(ell, _work=EllWork(work.rows, work.cols, work.weights, work.items[~hub],
                                                    work.zero_rows))
    hub_only = dataclasses.replace(ell, _work=EllWork(work.rows, work.cols, work.weights, work.items[hub],
                                                      work.zero_rows[:0]))
    in_deg = np.bincount(g.dst, minlength=n)
    real = int(((work.cols >= 0) & (work.cols < n)).sum())
    hub_slots = int(sum(int(c) * int(w) for _, c, w, _ in work.items[hub].tolist()))

    idx = torch.from_numpy(np.stack([g.dst, g.src]).astype(np.int64)).to(dev)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a_csr = torch.sparse_coo_tensor(idx, torch.ones(g.num_edges, device=dev), (n, n)).coalesce().to_sparse_csr()

    rng = np.random.default_rng(0)
    out = {"label": args.label, "src": args.src, "nodes": n, "edges": g.num_edges, "graph_host_s": t_graph,
           "build_ell_host_s": t_ell, "max_in_degree": int(in_deg.max()), "hub_items": int(hub.sum()),
           "hub_widths": sorted({int(w) for w in work.items[hub, 2].tolist()}), "hub_slots": hub_slots,
           "rows_in_degree_ge_1024": int((in_deg >= HUB_WIDTH).sum()), "real_slots": real,
           "work_items": int(work.items.shape[0]), "dims": {}}
    for d in (int(v) for v in args.dims.split(",")):
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        with torch.inference_mode():
            got = segment_spmm(x, ell)
            again = segment_spmm(x, ell)
            want = segment_spmm_ref(x, ell)
            lib = torch.sparse.mm(a_csr, x)
            torch.cuda.synchronize()
            err_ref = float((got - want).abs().max())
            err_lib = float((got - lib).abs().max())
            if not (torch.allclose(got, want, **TOL) and torch.allclose(got, lib, **TOL)):
                raise AssertionError(f"D={d}: reduce vs plain version {err_ref}, vs torch.sparse.mm {err_lib}")
            touched = int(torch.unique(work.cols[(work.cols >= 0) & (work.cols < n)]).numel())
            nbytes = touched * d * 4 + real * 4 + n * d * 4  # x's rows read, real cols, the output
            out["dims"][str(d)] = {
                "ms": replay_ms(lambda: segment_spmm(x, ell)),
                "no_hub_ms": replay_ms(lambda: segment_spmm(x, no_hub)),
                "hub_only_ms": replay_ms(lambda: segment_spmm(x, hub_only)),
                "library_ms": replay_ms(lambda: torch.sparse.mm(a_csr, x)),
                "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "max_abs_err_vs_plain": err_ref, "max_abs_err_vs_library": err_lib,
                "two_runs_bit_equal": bool(torch.equal(got, again)),
            }
    out["card"] = smi_name_and_power_limit()
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
