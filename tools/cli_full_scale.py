#!/usr/bin/env python3
"""The paper grid through the port's sweep CLI at the published sizes, on one GPU.

    python3 tools/cli_full_scale.py [--out chiprun_out/cli_full_scale]

Runs `python -m repro_torch.experiments.run --grid paper --scale 1.0` in
process (all four Table-2 workloads, up to ljournal's 78 M edges) into
`--out`, and prints one JSON line: the wall time, the
payload's stage split, the host's peak RSS after each stage, the device's
peak allocated memory, the `segment_spmm` launches, each workload's size and
the card's name and power limit.  A stage that does not finish still leaves
its progress lines (printed as the sweep goes) on standard output.  Needs a
CUDA device; a run without one fails.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "cli_full_scale"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cli_full_scale: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    from repro_torch.device import smi_name_and_power_limit
    from repro_torch.experiments.run import main as run_main
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    os.makedirs(args.out, exist_ok=True)
    md, js = os.path.join(args.out, "EXPERIMENTS.md"), os.path.join(args.out, "BENCH_sweep.json")
    torch.cuda.reset_peak_memory_stats()
    segment_spmm.launches = ell_spmm.launches = 0
    with tempfile.TemporaryDirectory() as tmp:  # the traces' cache stays out of --out
        t0 = time.perf_counter()
        rc = run_main([
            "--grid", "paper", "--scale", "1.0", "--md", md, "--json", js,
            "--sweeps-dir", os.path.join(tmp, "sweeps"), "--cache-dir", os.path.join(tmp, "cache"),
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(js) as f:
        payload = json.load(f)
    print(json.dumps({
        "grid": payload["grid"]["name"], "scale": payload["grid"]["scale"], "rc": rc, "wall_s": wall,
        "records": len(payload["records"]), "backend": payload["backend"],
        "timings": payload["timings"], "peak_rss_mb_after_stage": payload["memory"],
        "device_peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "segment_spmm_launches": segment_spmm.launches, "ell_spmm_launches": ell_spmm.launches,
        "workloads": {w: {"nodes": s["num_nodes"], "edges": s["num_edges"]}
                      for w, s in payload["workload_stats"].items()},
        "min_speedup": min(c["speedup"] for c in payload["comparisons"]),
        "max_speedup": max(c["speedup"] for c in payload["comparisons"]),
        "card": smi_name_and_power_limit(), "device": torch.cuda.get_device_name(0),
    }), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
