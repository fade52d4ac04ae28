#!/usr/bin/env python3
"""Where a dense training step's device time goes: one device, Megatron TP and FSDP on a (2, 8) mesh, on one GPU.

    python3 tools/dense_mesh_step.py [--layers 28] [--batch 16] [--seq 128]

llama3.2-3b at its published width (`--layers` of its 28) trained by hand
(`transformer.loss_fn`, `torch.autograd.grad`, the launcher's AdamW with
clip 1.0) on one device and on ("data", "model") = (2, 8) stacked on the
card under `MeshRules(strategy="tp_sp")` and `"fsdp"` (every leaf laid out
by `transformer.shard_params`), one route after another on the same seeded
weights and Zipf token batches (no two training states alive at once).
Each route takes two warm steps, then `torch.profiler` (device activity)
over the gradient (forward and backward) and over the optimizer's update of
one step, apart: device ms by kernel group (GEMMs, attention forward and
backward, copies, reductions, the rest) and each window's busy share; then
the median host-clock step of `--steps` synchronised steps.  Prints one
JSON line with the card's name and power limit.  Needs a CUDA device; a run
without one fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

GROUPS = {"gemm_ms": ("gemm", "xmma", "cutlass", "nvjet", "sm90_"), "attention_forward_ms": ("attn_bf16_wgmma",),
          "attention_backward_ms": ("attn_bwd_",), "copy_ms": ("copy", "Copy"), "reduce_ms": ("reduce_kernel",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("dense_mesh_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_rows, summarize_profile
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.kernels.build import build_library
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules
    from repro_torch.train.optim import adamw
    from repro_torch.train.pytree import tree_leaves, tree_unflatten

    for name in ("flash_attention", "flash_attention_bwd"):
        build_library(name)
    dev = torch.device("cuda")
    mesh = make_mesh((2, 8), ("data", "model"), device=dev)
    base = dataclasses.replace(get_arch("llama3.2-3b").model_config(), n_layers=args.layers)
    data = TokenPipeline(base.vocab, args.seq, args.batch, seed=args.seed)
    batches = [to_device(b, dev) for b in itertools.islice(data, 3 + args.steps)]
    runs = {}
    for route in ("one_device", "tp_sp", "fsdp"):
        on = route != "one_device"
        cfg = dataclasses.replace(base, rules=MeshRules(strategy=route)) if on else base
        m = mesh if on else None
        params = tfm.init_params(cfg, args.seed, device=dev)
        if on:
            params = tfm.shard_params(params, cfg, mesh)
        opt = adamw(1e-4, mesh=m, sharded=tfm.sharded_specs(cfg, mesh) if on else {})
        state = opt.init(params)

        def grads(batch):
            leaves = tree_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            return tree_unflatten(params, torch.autograd.grad(tfm.loss_fn(params, batch, cfg, mesh=m), leaves))

        def step(i, batch):
            opt.update(grads(batch), state, params, i)

        def window(fn):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return out, summarize_profile(device_rows(prof), wall, GROUPS)

        for i in range(2):
            step(i, batches[i])
        g, grad_split = window(lambda: grads(batches[2]))
        opt_split = window(lambda: opt.update(g, state, params, 2))[1]  # the update returns the state: not kept
        del g
        walls = []
        for i, batch in enumerate(batches[3:], start=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(i, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        for split in (grad_split, opt_split):
            split["rest_ms"] = split["device_ms"] - sum(split[k] for k in GROUPS)
        runs[route] = {"gradient": grad_split, "optimizer": opt_split, "step_ms_median": statistics.median(walls),
                       "step_ms": walls, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tool": "dense_mesh_step", "arch": base.name, "layers": args.layers, "batch": args.batch,
                      "seq": args.seq, "mesh": dict(mesh.shape), "runs": runs, "card": smi,
                      "timing": "gradient and optimizer: torch.profiler device time over one step's window each, "
                                "busy share = device ms / the window's host wall; step_ms: host clock around a "
                                "synchronised step (batch on the device)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
