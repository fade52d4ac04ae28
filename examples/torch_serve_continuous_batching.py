"""Serving scenario, in the PyTorch port: continuous batching over a fixed
slot pool.

    PYTHONPATH=src python examples/torch_serve_continuous_batching.py [--device cpu]

Requests with mixed prompt lengths arrive; the engine admits them into free
KV-cache slots, decodes one token per engine step for every active slot,
and refills slots as requests finish — the lines of
`examples/serve_continuous_batching.py`, through
`repro_torch.launch.serve.build_engine` on the card unless `--device cpu`
is given.  Every prefill runs the attention kernel (`flash_attention`).

The model is llama3.2-3b's smoke configuration with its 64-wide attention
split into 2 heads of 32 (the smoke configuration's 4 heads of 16 are a
head dim the kernel does not take; the weights have the same shapes).  Its
weights are drawn on the CPU from a `torch.Generator` seeded with 0 and
moved to the device, so the card serves the tokens the CPU serves.
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_engine
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request
from repro_torch.train.pytree import tree_map

SLOTS, MAX_SEQ, REQUESTS, NEW_TOKENS = 4, 96, 10, 12


def serve_config():
    """llama3.2-3b's smoke configuration, its attention as 2 heads of 32."""
    return dataclasses.replace(get_arch("llama3.2-3b").smoke_config(), n_heads=2, n_kv_heads=2)


def requests(vocab: int) -> list[tuple[int, np.ndarray]]:
    """The reference example's 10 (uid, prompt) pairs, from `default_rng(0)`."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(REQUESTS):
        plen = int(rng.integers(4, 24))
        out.append((i, rng.integers(2, vocab, plen).astype(np.int32)))
    return out


def where(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"


def serve(cfg, params: dict, device):
    """Drain the example's requests through `build_engine(cfg, params)` on
    `device`, printing the reference example's lines; returns the engine and
    {"steps", "tokens", "seconds", "idle_steps"}, where `idle_steps` counts
    the steps that ran with a free slot while a request waited."""
    device = resolve_device(device)
    engine = build_engine(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, device=device)
    for uid, prompt in requests(cfg.vocab):
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=NEW_TOKENS))

    t0 = time.perf_counter()
    steps = idle_steps = 0
    while engine.queue or any(a is not None for a in engine.active):
        live = engine.step()
        steps += 1
        idle_steps += bool(engine.queue) and live < engine.slots
        if steps % 8 == 0:
            print(f"step {steps:3d}: {live} active, {len(engine.queue)} queued, "
                f"{len(engine.completed)} done")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in engine.completed)
    idle = ("slots never idle while queue non-empty" if idle_steps == 0
            else f"{idle_steps} steps with a slot idle while requests waited")
    print(f"\n{len(engine.completed)} requests, {toks} tokens, {dt:.1f}s "
        f"({toks/dt:.1f} tok/s on {where(device)}; {idle})")
    return engine, {"steps": steps, "tokens": toks, "seconds": dt, "idle_steps": idle_steps}


def main(argv=None):
    """Serve the example's requests; returns what `serve` returns."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the engine's device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = serve_config()
    params = tree_map(lambda t: t.to(device), tfm.init_params(cfg, 0, device="cpu"))
    return serve(cfg, params, device)


if __name__ == "__main__":
    main()
