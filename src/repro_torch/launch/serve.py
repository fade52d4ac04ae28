"""Serving driver: continuous-batching decode over an LM of the registry.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 12 --slots 4 --max-new 16

serves `smoke_config()` of the arch on the card (`--device cpu` runs it on the
host); `--arch olmoe-1b-7b` and `--arch qwen2-moe-a2.7b` serve the MoE archs'
smoke configs.  `build_engine` takes any `TransformerConfig`; `chip_smoke.py`
drives it at the published widths of llama3.2-3b and olmoe-1b-7b, on one
device and on a ("data", "model") engine mesh.
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
                 device: str | torch.device | None = None, mesh=None) -> ServeEngine:
    """An engine over `params` on `device` (None: the card) with a float32 KV
    cache of `slots` × `max_seq` positions.  The weights are kept once, in
    `cfg.dtype` (`tfm.cast_params`).  `mesh`: the engine mesh (e.g.
    `graph.distributed.make_mesh((2, 8), ("data", "model"))`) that every
    prefill and decode step hands the model.  A dense model is served on it
    by Megatron TP or FSDP as `cfg.rules` says, an MoE model with
    impl="ep_shardmap" by Megatron TP attention and EP experts (tp_sp): its
    params laid out (`tfm.shard_params`, unless they are already) and its
    cache laid out by `tfm.kv_cache_specs`, which splits the slots over the
    rules' batch axes (a slot count that does not divide raises).  An MoE
    model with impl="local" ignores the mesh."""
    dev = resolve_device(device)
    tfm.kv_cache_shape(cfg, slots, max_seq, mesh)  # raises for slots that do not divide over the batch axes
    params = tfm.cast_params(params, cfg, device=dev)
    if mesh is not None and params["embed"].dim() == 2:  # whole: lay it out
        params = tfm.shard_params(params, cfg, mesh)

    def init_cache():
        return tfm.init_kv_cache(cfg, slots, max_seq, dtype=torch.float32, device=dev, mesh=mesh)

    def prefill_one(cache, slot, tokens):
        # the slot's row of the slot-batched cache, written in place
        logits, _ = tfm.prefill(params, tokens.to(dev), cache, cfg, mesh=mesh, slot=slot)
        return cache, logits

    def decode(cache, tokens, pos):
        # per-slot positions: every slot decodes at its own offset; masking
        # handles inactive slots
        return tfm.decode_step_batched_pos(params, cache, pos.to(dev), tokens.to(dev), cfg, mesh=mesh)

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
