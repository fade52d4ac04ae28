#!/usr/bin/env python3
"""One olmoe-1b-7b MoE layer with expert parallelism against the local path, on one GPU.

    python3 tools/moe_ep_layer.py [--src DIR] [--label NAME] [--seed 0]

The layer is olmoe-1b-7b's at its published width (64 experts top-8 of
width 1024, d_model 2048; random weights from a seeded generator, bf16 over
a float32 master, the router in float32), on 16 engines stacked as
("data", "model") = (2, 8).  For each shape it times `moe_block` with
impl="ep_shardmap" and with impl="local" on the same weights and tokens, in
turns (local, EP, EP, local), with CUDA events over calls enqueued back to
back (what a caller sees, the host's enqueue included): a prefill of 2,690
tokens and a decode step of 4 (the serve phases' longest prompt and slots),
forward only; a training step's 8 × 128 tokens, forward and backward.
Prints one JSON line with the card's name and power limit.

`--src` names the `src` directory whose `repro_torch` is imported (default:
this checkout's), so that one call can time another checkout's EP beside
this one's; a tree whose EP takes the whole expert stacks gets them whole.
Needs a CUDA device; a run without one fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"prefill": (1, 2690, False), "decode": (4, 1, False), "train": (8, 128, True)}  # (B, S, backward)
TURNS = ("local", "ep", "ep", "local")


def call_ms(fn, calls: int, reps: int = 7) -> float:
    """Median of `reps` timings of `calls` calls enqueued back to back (CUDA events), a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    if not torch.cuda.is_available():
        print("moe_ep_layer: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").model_config(), n_layers=1)
    m = cfg.moe
    ep = dataclasses.replace(m, impl="ep_shardmap")
    mesh = make_mesh((2, 8), ("data", "model"), device=dev)
    lp = {k: v[0] for k, v in tfm.cast_params(tfm.init_params(cfg, args.seed, device=dev), cfg)["layers"].items()
          if k in moe.layer_shapes(m, cfg.d_model)}
    lp_ep = moe.shard_experts(ep, lp, mesh) if hasattr(moe, "shard_experts") else lp
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    out = {"label": args.label, "src": args.src, "arch": "olmoe-1b-7b", "layer": "one MoE layer, bf16",
           "mesh": dict(mesh.shape), "turns": list(TURNS)}
    for name, (b, s, backward) in SHAPES.items():
        x = (torch.randn((b, s, cfg.d_model), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)

        def run(c, w):
            if not backward:
                with torch.no_grad():
                    return moe.moe_block(c, w, x, mesh=mesh)
            wg = {k: v.detach().requires_grad_(True) for k, v in w.items()}
            xi = x.detach().requires_grad_(True)
            return torch.autograd.grad((moe.moe_block(c, wg, xi, mesh=mesh) * dy).sum(), [xi, *wg.values()])

        routes = {"local": lambda: run(m, lp), "ep": lambda: run(ep, lp_ep)}
        times = {"local": [], "ep": []}
        for turn in TURNS:
            times[turn].append(call_ms(routes[turn], calls=5 if backward else 10))
        out[name] = {"tokens": b * s, "backward": backward, "runs_ms": times,
                     **{f"{k}_ms": statistics.mean(v) for k, v in times.items()}}
        out[name]["ep_over_local"] = out[name]["ep_ms"] / out[name]["local_ms"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out["card"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
