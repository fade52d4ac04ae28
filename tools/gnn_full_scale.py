#!/usr/bin/env python3
"""gin-tu at the published size of its `ogb_products` cell, on one GPU.

    python3 tools/gnn_full_scale.py [--seed 0]

Generates the R-MAT graph of `GNN_SHAPES["ogb_products"]` (2,449,029 nodes,
61,859,140 edges) on the host, then runs `chip_smoke.gin_at_scale` on it:
`GraphBatcher`'s full batch at d_feat 100, `models.gnn.batch_ell`, gin-tu's
forward and loss on the ELL route (wall, device time by kernel, busy share),
and one reduce at D = 100 and D = 64 beside its bound, `torch.sparse.mm`
(CSR), the scatter route's sum and the plain version, each checked against
the kernel.  The scatter route is compared one layer's sum at a time, not as
a whole forward: it materialises E × D messages, 24.7 GB at D = 100, twice
over.  Prints one JSON line: host seconds by stage, those numbers, the
host's peak RSS and the device's peak allocated memory, and the card's name
and power limit.  Needs a CUDA device; a run without one fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gnn_full_scale: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    import chip_smoke
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.device import smi_name_and_power_limit
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.build import build_library

    device = torch.device("cuda")
    t0 = time.perf_counter()
    build_library("ell_spmm")
    build_s = time.perf_counter() - t0
    sh = GNN_SHAPES[chip_smoke.GNN_WIDE_CELL]
    t0 = time.perf_counter()
    graph = rmat(sh["n_nodes"], sh["n_edges"], seed=args.seed, name=chip_smoke.GNN_WIDE_CELL)
    graph_s = time.perf_counter() - t0
    rss_graph_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = chip_smoke.gin_at_scale(device, graph, chip_smoke.Timer(), seed=args.seed, full_scatter=False)
    torch.cuda.synchronize()
    print(json.dumps({
        "tool": "gnn_full_scale", "cell": chip_smoke.GNN_WIDE_CELL, "seed": args.seed,
        "build_s": build_s, "graph_host_s": graph_s, "gin_at_scale_s": time.perf_counter() - t0,
        **out, "segment_spmm_launches": launches,
        "host_peak_rss_mb_after_graph": rss_graph_mb,
        "host_peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "device_peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": smi_name_and_power_limit(), "device": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
