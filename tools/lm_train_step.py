#!/usr/bin/env python3
"""One llama3.2-3b training step at its published width and depth, two ways of splitting the layers, on one GPU.

    python3 tools/lm_train_step.py [--steps 4] [--batch 8] [--seq 128]

`models.transformer.forward` reads each layer's weights out of the stacked
`(L, …)` leaves.  Two ways, timed in turns on one card (unbind, select,
select, unbind): `torch.unbind` of every leaf once a forward (the port's
way; its backward is one `stack` a leaf) and indexing the leaf once a layer
(`_layer(params, i)`; each index's backward adds a leaf-sized zero tensor).
Each turn runs one warm step and `--steps` timed steps of `make_train_step`
(the loss in fp32, AdamW with clip 1.0, per-layer recompute) on Zipf token
batches at the reference's defaults (batch 8, seq 128), weights from a seeded
generator on the card, and records the median step (host clock around a
synchronised step), the device's peak memory and the attention kernels'
launches a step.  Prints one JSON line with the card's name and power limit.
Needs a CUDA device; a run without one fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lm_train_step: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.models import transformer as tfm
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule

    dev = torch.device("cuda")
    cfg = get_arch("llama3.2-3b").model_config()
    params = tfm.init_params(cfg, args.seed, device=dev)
    init, step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), adamw(cosine_schedule(1e-3, 10, 100)))
    state = init(params)
    data = iter(TokenPipeline(cfg.vocab, args.seq, args.batch, seed=args.seed))
    unbind = tfm._layers
    variants = {"unbind": unbind, "select": lambda p, n: [tfm._layer(p, i) for i in range(n)]}
    runs = []
    for name in ("unbind", "select", "select", "unbind"):
        tfm._layers = variants[name]
        state, m = step(state, to_device(next(data), dev))  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        fa0, bwd0 = flash_attention.launches, flash_attention_bwd.launches
        for _ in range(args.steps):
            batch = to_device(next(data), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        runs.append({"variant": name, "step_ms_median": statistics.median(walls), "step_ms": walls,
                     "losses": losses, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "attention_forward_launches_a_step": (flash_attention.launches - fa0) / args.steps,
                     "attention_backward_launches_a_step": (flash_attention_bwd.launches - bwd0) / args.steps})
    tfm._layers = unbind
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tool": "lm_train_step", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                      "batch": args.batch, "seq": args.seq, "runs": runs, "card": smi,
                      "timing": "host clock around one synchronised step (batch already on the device)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
