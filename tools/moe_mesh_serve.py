#!/usr/bin/env python3
"""MoE serving under Megatron TP attention and EP experts on a (2, 8) mesh, on one GPU: the phase alone, and where the time goes.

    python3 tools/moe_mesh_serve.py [--only phase|split] [--layers 16] [--prompt 2048] [--steps 8]

"phase" runs `chip_smoke.phase_mesh_moe_serve` alone (the attention kernel
built first): olmoe-1b-7b and qwen2-moe-a2.7b served through
`launch.serve.build_engine(..., mesh=)` under tp_sp with EP beside one
device's impl="local" engine, the float32 checks, NCCL at world size 1, the
attention kernel at the per-engine prefill shape; it prints the
`mesh_moe_serve` line.  "split" serves olmoe-1b-7b at its published width
(`--layers` of its 16), bf16 weights from a seeded generator, through
`build_engine` (4 slots, 4,096 positions, a float32 KV cache) on one device
(impl="local") and on ("data", "model") = (2, 8) stacked on the card
(impl="ep_shardmap" under tp_sp: every leaf and the cache laid out), one
route after another on the same weights.  Each route takes a warm prefill
and decode step, then `torch.profiler` (device activity) over one one-slot
prefill of a `--prompt`-token prompt and, apart, over `--steps` decode steps
of the 4 slots: device ms by kernel group (GEMMs, the attention kernel,
copies, sorts, indexing and scatters, reductions, the rest) and each
window's busy share; then the median host-clock prefill and decode step of
three synchronised calls each.  Both print one JSON line with the card's
name and power limit.  Needs a CUDA device; a run without one fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
          "copy_ms": ("copy", "Copy"), "sort_ms": ("sort", "Sort", "radix"),
          "index_ms": ("index", "gather", "scatter"), "reduce_ms": ("reduce_kernel",)}
SLOTS, MAX_SEQ = 4, 4096


def split(args, torch, smi: str) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_rows, summarize_profile
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    mesh = make_mesh((2, 8), ("data", "model"), device=dev)
    base = dataclasses.replace(get_arch("olmoe-1b-7b").model_config(), n_layers=args.layers)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(2, base.vocab, (1, args.prompt)))
    step_tokens = torch.from_numpy(rng.integers(2, base.vocab, (SLOTS, 1)))
    pos = torch.from_numpy(args.prompt - rng.integers(0, 64, SLOTS))
    params = tfm.cast_params(tfm.init_params(base, args.seed, device=dev), base)
    runs = {}
    for route in ("one_device", "tp_ep"):
        on = route != "one_device"
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, impl="ep_shardmap")) if on else base
        engine = build_engine(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device=dev, mesh=mesh if on else None)
        cache = engine.cache

        def prefill():
            return engine.prefill_one(cache, 0, prompt)

        def decode(n: int):
            for i in range(n):
                engine.decode(cache, step_tokens, pos + i)

        def window(fn):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out = summarize_profile(device_rows(prof), wall, GROUPS)
            out["rest_ms"] = out["device_ms"] - sum(out[k] for k in GROUPS)
            return out

        def host_ms(fn) -> list[float]:
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            return walls

        with torch.no_grad():
            prefill()
            decode(1)
            prefill_split, decode_split = window(prefill), window(lambda: decode(args.steps))
            prefill_ms, decode_ms = host_ms(prefill), host_ms(lambda: decode(1))
        runs[route] = {"prefill": prefill_split, "decode_steps": decode_split,
                       "prefill_ms_median": statistics.median(prefill_ms), "prefill_ms": prefill_ms,
                       "decode_ms_a_step_median": statistics.median(decode_ms), "decode_ms": decode_ms,
                       "kv_cache_shape": list(cache["k"].shape),
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del engine, cache
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return {"tool": "moe_mesh_serve", "arch": base.name, "layers": args.layers, "prompt": args.prompt,
            "slots": SLOTS, "decode_steps": args.steps, "mesh": dict(mesh.shape), "runs": runs, "card": smi,
            "timing": "prefill and decode_steps: torch.profiler device time over one window each, busy share = "
                      "device ms / the window's host wall; *_ms: host clock around three synchronised calls"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("phase", "split"), default=None)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("moe_mesh_serve: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.build import build_library

    build_library("flash_attention")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.only in (None, "phase"):
        chip_smoke.phase_mesh_moe_serve(torch.device("cuda"), args.seed, smi, chip_smoke.Timer())
        gc.collect()
        torch.cuda.empty_cache()
    if args.only in (None, "split"):
        print(json.dumps(split(args, torch, smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
