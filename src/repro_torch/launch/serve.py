"""Serving driver: continuous-batching decode over an LM of the registry.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 12 --slots 4 --max-new 16

serves `smoke_config()` of the arch on the card (`--device cpu` runs it on the
host); `--arch olmoe-1b-7b` and `--arch qwen2-moe-a2.7b` serve the MoE archs'
smoke configs.  `build_engine` takes any `TransformerConfig`; `chip_smoke.py`
drives it at the published widths of llama3.2-3b and olmoe-1b-7b.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import arch_ids, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.obs import span
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["build_engine", "main"]


def build_engine(cfg: tfm.TransformerConfig, params: dict, *, slots: int, max_seq: int,
                 device: str | torch.device | None = None) -> ServeEngine:
    """An engine over `params` on `device` (None: the card) with a float32 KV
    cache of `slots` × `max_seq` positions.  The weights are kept once, in
    `cfg.dtype` (`tfm.cast_params`)."""
    dev = resolve_device(device)
    params = tfm.cast_params(params, cfg, device=dev)

    def init_cache():
        return tfm.init_kv_cache(cfg, slots, max_seq, dtype=torch.float32, device=dev)

    def prefill_one(cache, slot, tokens):
        # the slot's range of the slot-batched cache, as views: prefill writes it in place
        sub = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1]}
        logits, _ = tfm.prefill(params, tokens.to(dev), sub, cfg)
        return cache, logits

    def decode(cache, tokens, pos):
        # per-slot positions: every slot decodes at its own offset; masking
        # handles inactive slots
        return tfm.decode_step_batched_pos(params, cache, pos.to(dev), tokens.to(dev), cfg)

    return ServeEngine(slots=slots, max_seq=max_seq, init_cache=init_cache,
                       prefill_one=prefill_one, decode=decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=arch_ids("lm"), default="llama3.2-3b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke_config()
    params = tfm.init_params(cfg, 0, device=args.device)
    engine = build_engine(cfg, params, slots=args.slots, max_seq=args.max_seq, device=args.device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(2, cfg.vocab, size=rng.integers(4, 17)).astype(np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    with span("serve.drain", cat="launch", requests=args.requests) as sp:
        done = engine.run_until_drained()
    dt = sp.duration_s
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, continuous batching over {args.slots} slots)")


if __name__ == "__main__":
    main()
