#!/usr/bin/env python3
"""Where the device time goes in the port's vertex engine and sweep, on one GPU.

    python3 tools/profile_engine.py [--scale 1.0] [--out artifacts/torch/profile_engine.json]

Traces `run_traced` (BFS, SSSP, PageRank with the ELL kernel and with
`index_add_`) and one `run_sweep` of the 12-configuration `amazon` grid under
`torch.profiler`, and prints for each: the wall time, the summed device time
of all kernels, the device's busy share (device time over wall time) and the
kernels that took most of it.  Needs a CUDA device; a run without one fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


# rows of the profiler that are its own bookkeeping on the device, not work
NOT_WORK = ("Activity Buffer Request", "Runtime Triggered Module Loading")


def profiled(label: str, fn) -> dict:
    """`fn` may return a dict of its own timings, which is kept beside the
    profile.  Only device-side rows (kernels and copies) are summed: an
    operator's row repeats the device time of the kernels it launched."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(
        ((device_us(e), e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.key not in NOT_WORK),
        reverse=True,
    )
    total_us = sum(r[0] for r in rows)
    out = {
        "what": label, "wall_s": wall, "device_s": total_us / 1e6,
        "device_busy_share": total_us / 1e6 / wall if wall else None,
        **(extra if isinstance(extra, dict) else {}),
        "top_kernels": [{"name": k[:90], "device_ms": us / 1e3, "calls": n} for us, k, n in rows[:8] if us > 0],
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="artifacts/torch/profile_engine.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.device import smi_name_and_power_limit
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.experiments.sweep import run_sweep
    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.generators import table2_workloads
    from repro_torch.graph.vertex_program import run_traced
    from repro_torch.kernels.segment_spmm import kernel

    kernel.build()
    graph = table2_workloads(scale=args.scale, names=("amazon",))["amazon"]

    def trace(name, **kw):
        g = alg.prepare_graph(name, graph)

        def go():
            t: dict = {}
            tr = run_traced(g, alg.ALGORITHMS[name](), device="cuda", timings=t,
                            max_iterations=40 if name == "pagerank" else 200, **kw)
            return {"iterations": tr.num_iterations, **t}

        return go

    trace("pagerank")()  # warm: library load, allocator, cuBLAS handles
    results = [
        profiled("run_traced bfs", trace("bfs")),
        profiled("run_traced sssp", trace("sssp")),
        profiled("run_traced pagerank reduce_impl=ell", trace("pagerank", reduce_impl="ell")),
        profiled("run_traced pagerank reduce_impl=scatter", trace("pagerank", reduce_impl="scatter")),
    ]
    grid = dataclasses.replace(GRIDS["paper"], name="paper-amazon", workloads=("amazon",), scale=args.scale)
    results.append(profiled(
        "run_sweep 12 configs backend=torch",
        lambda: {"timings_s": run_sweep(grid, backend="torch", device="cuda", graphs={"amazon": graph},
                                        measure_serial=False).timings},
    ))
    card = smi_name_and_power_limit()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "scale": args.scale,
                               "nodes": graph.num_nodes, "edges": graph.num_edges, "results": results}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
