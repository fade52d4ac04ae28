"""End-to-end training driver:  --arch <id> [--steps N] [--smoke].

The port of `repro.launch.train`: config → model → data pipeline → train
step → checkpointed loop, on one device (`--device`, default the card).
Without `--smoke` it runs the published configuration, as the reference
does; the batches are made on the host by a prefetch thread and reach the
device through pinned memory without blocking.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --batch 65536 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --smoke --device cpu --steps 3

The recsys family (dcn-v2) trains.  The LM and GNN families raise: the
attention kernel and the ELL reduce that GIN's sum goes through have no
backward yet (ROADMAP.md Queue B 4; LM and GNN training are Queue A 8).  The
GNN models themselves are ported (`models/gnn.py`) and run forward on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import typing

import torch

from repro_torch.configs.registry import ARCH_IDS, PENDING, get_arch
from repro_torch.data.pipeline import Prefetcher, RecsysPipeline, to_device
from repro_torch.device import resolve_device
from repro_torch.models import recsys as rec_lib
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.loop import TrainLoop, TrainState, make_train_step
from repro_torch.train.optim import adamw, cosine_schedule
from repro_torch.train.pytree import tree_leaves

__all__ = ["train", "main"]

_NOT_PORTED = {
    "lm": "LM training is not ported: the flash-attention kernel has no backward "
          "(ROADMAP.md Queue B 4; LM training is Queue A 8)",
    "gnn": "GNN training is not ported: the ELL reduce of GIN's sum (segment_spmm) has no backward "
           "(ROADMAP.md Queue B 4; GNN training is Queue A 8)",
}


def _recsys_setup(arch, *, smoke: bool, batch: int, seed: int, device: torch.device, bag_impl: str):
    cfg = arch.smoke_config() if smoke else arch.model_config()
    cfg = dataclasses.replace(cfg, bag_impl=bag_impl)
    params = rec_lib.init_params(cfg, seed, device=device)
    loss = lambda p, b: rec_lib.loss_fn(p, b, cfg)  # noqa: E731
    data = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, batch, seed=seed)
    return cfg, params, loss, data


def train(
    arch_id: str,
    *,
    steps: int = 100,
    batch: int = 8,
    lr: float = 1e-3,
    smoke: bool = False,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    compress_grads: bool = False,
    device: str | torch.device | None = None,
    seed: int = 0,
    bag_impl: str = "auto",
    on_step: typing.Callable | None = None,
    log_fn: typing.Callable[[str], None] = print,
) -> TrainState:
    """Train `arch_id` for `steps` steps on `device` (None: the card) and
    return the final state.  `bag_impl` picks the embedding-bag route (the
    kernel by default); `on_step(state, metrics, batch)` sees every step."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    if arch.family in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[arch.family])
    cfg, params, loss, data = _recsys_setup(arch, smoke=smoke, batch=batch, seed=seed, device=dev,
                                            bag_impl=bag_impl)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log_fn(f"[train] {arch_id} family={arch.family} params={n_params:,} device={dev}")

    opt = adamw(cosine_schedule(lr, 10, steps))
    init_state, step = make_train_step(loss, opt, compress=compress_grads)
    state = init_state(params)
    ckpt = Checkpointer(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    loop = TrainLoop(step, checkpointer=ckpt, log_fn=log_fn, on_step=on_step)
    batches = Prefetcher(to_device(b, dev) for b in data)
    try:
        state = loop.run(state, batches, num_steps=steps)
    finally:
        batches.close()
    log_fn(f"[train] done at step {state.step}")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + list(PENDING), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, lr=args.lr, smoke=args.smoke,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, compress_grads=args.compress_grads,
          device=args.device)


if __name__ == "__main__":
    main()
