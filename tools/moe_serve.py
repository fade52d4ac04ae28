#!/usr/bin/env python3
"""MoE serving alone on one GPU: the `moe` phase of `chip_smoke.py`.

    python3 tools/moe_serve.py [--seed 0]

Builds the attention kernel (`csrc/flash_attention.cu`), then runs
`chip_smoke.phase_moe`: the kernel at olmoe-1b-7b's prefill shape against
its plain version; olmoe-1b-7b at its published width and depth through
`launch.serve.build_engine` (4 slots, max_seq 4096, float32 cache, 8
requests of 512-3072 prompt tokens and 32 new tokens each) and
qwen2-moe-a2.7b at its published width over 4 of its 24 layers (one prompt
of 2048 tokens, 8 decode steps), with their logit checks, `moe_block`
against `moe_loop_ref`, routing statistics (C, dropped slots, expert load
skew), the device split of a prefill and of a decode step and the decode
step's byte bound.  Prints the `moe` JSON line (with the card's name and
power limit) and nothing after it.  Needs a CUDA device; a run without one
fails.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("moe_serve: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from chip_smoke import Timer, phase_moe, say
    from repro_torch.device import probe
    from repro_torch.kernels.build import build_library

    info = probe()
    say("build", library=build_library("flash_attention").name)
    phase_moe(torch.device("cuda"), args.seed, info["nvidia_smi"], Timer())
    return 0


if __name__ == "__main__":
    sys.exit(main())
