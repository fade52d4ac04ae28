"""End-to-end training driver:  --arch <id> [--steps N] [--smoke].

The port of `repro.launch.train`: config → model → data pipeline → train
step → checkpointed loop, on one device (`--device`, default the card).
Without `--smoke` it runs the published configuration, as the reference
does, with the reference's data: Zipf token batches (`TokenPipeline`, made on
the host by a prefetch thread) for the LM family; one full batch of an R-MAT
graph of 512 nodes and 4,096 edges (`GraphBatcher`, at the `full_graph_sm`
widths), put on the device once and repeated, for the GNN family; Criteo-
shaped Zipf batches (`RecsysPipeline`, prefetched) for dcn-v2.  Batches reach
the device through pinned memory without blocking.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --batch 65536 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu --steps 2 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu --steps 2

On the card every kernel of the path has a backward: attention through the
kernel `csrc/flash_attention_bwd.cu`, GIN's ELL reduce through the same
fused kernel over the transposed ELL, the embedding bag through its
Function.  The MoE archs (olmoe-1b-7b, qwen2-moe-a2.7b) train as the
reference trains them, on cross-entropy alone, their experts `impl="local"`.
At full depth olmoe-1b-7b's float32 params, grads and AdamW moments come to
111 GB, more than one H100 holds: `train(..., cfg=...)` trains a
configuration of the caller's (`chip_smoke.py` cuts the depth).  graphcast
is refused, as the reference refuses it.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import typing

import torch

from repro_torch.configs.registry import ARCH_IDS, PENDING, get_arch
from repro_torch.data.pipeline import GraphBatcher, Prefetcher, RecsysPipeline, TokenPipeline, to_device
from repro_torch.device import resolve_device
from repro_torch.graph.generators import rmat
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.loop import TrainLoop, TrainState, make_train_step
from repro_torch.train.optim import adamw, cosine_schedule
from repro_torch.train.pytree import tree_leaves

__all__ = ["train", "main"]

GRAPHCAST_REFUSAL = "use examples/graphcast_regression.py for graphcast training"


def _lm_setup(arch, *, cfg=None, smoke: bool, batch: int, seq: int, seed: int, device: torch.device, **_):
    cfg = cfg or (arch.smoke_config() if smoke else arch.model_config())
    params = tfm.init_params(cfg, seed, device=device)
    loss = lambda p, b: tfm.loss_fn(p, b, cfg)  # noqa: E731
    batches = Prefetcher(to_device(b, device) for b in TokenPipeline(cfg.vocab, seq, batch, seed=seed))
    return cfg, params, loss, batches


def _gnn_setup(arch, *, cfg=None, smoke: bool, seed: int, device: torch.device, **_):
    cfg = cfg or (arch.smoke_config() if smoke else arch.model_config("full_graph_sm"))
    if cfg.kind == "graphcast":
        raise SystemExit(GRAPHCAST_REFUSAL)
    params = gnn_lib.init_params(cfg, seed, device=device)
    g = rmat(512, 4096, seed=seed)
    host = GraphBatcher(g, d_feat=cfg.d_in, n_classes=max(cfg.d_out, 2), seed=seed).full_batch()
    batch = to_device(host, device)
    if cfg.kind == "gin" and cfg.reduce_impl == "ell":  # one full batch, repeated: its ELLs are built once
        batch["ell"] = gnn_lib.batch_ell(host, device=device, transpose=True)
    loss = lambda p, b: gnn_lib.loss_fn(p, b, cfg)  # noqa: E731
    return cfg, params, loss, itertools.repeat(batch)


def _recsys_setup(arch, *, cfg=None, smoke: bool, batch: int, seed: int, device: torch.device, bag_impl: str, **_):
    cfg = cfg or (arch.smoke_config() if smoke else arch.model_config())
    cfg = dataclasses.replace(cfg, bag_impl=bag_impl)
    params = rec_lib.init_params(cfg, seed, device=device)
    loss = lambda p, b: rec_lib.loss_fn(p, b, cfg)  # noqa: E731
    data = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, batch, seed=seed)
    return cfg, params, loss, Prefetcher(to_device(b, device) for b in data)


_SETUP = {"lm": _lm_setup, "gnn": _gnn_setup, "recsys": _recsys_setup}


def train(
    arch_id: str,
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 1e-3,
    smoke: bool = False,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    compress_grads: bool = False,
    device: str | torch.device | None = None,
    seed: int = 0,
    bag_impl: str = "auto",
    cfg=None,
    on_step: typing.Callable | None = None,
    log_fn: typing.Callable[[str], None] = print,
) -> TrainState:
    """Train `arch_id` for `steps` steps on `device` (None: the card) and
    return the final state.  `seq` is the LM family's sequence length;
    `bag_impl` picks dcn-v2's embedding-bag route (the kernel by default);
    `cfg`, where given, is the model configuration to train in place of the
    arch's published one (or its smoke one); `on_step(state, metrics,
    batch)` sees every step."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    cfg, params, loss, batches = _SETUP[arch.family](arch, cfg=cfg, smoke=smoke, batch=batch, seq=seq, seed=seed,
                                                     device=dev, bag_impl=bag_impl)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log_fn(f"[train] {arch_id} family={arch.family} params={n_params:,} device={dev}")

    opt = adamw(cosine_schedule(lr, 10, steps))
    init_state, step = make_train_step(loss, opt, compress=compress_grads)
    state = init_state(params)
    ckpt = Checkpointer(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    loop = TrainLoop(step, checkpointer=ckpt, log_fn=log_fn, on_step=on_step)
    try:
        state = loop.run(state, batches, num_steps=steps)
    finally:
        if isinstance(batches, Prefetcher):
            batches.close()
    log_fn(f"[train] done at step {state.step}")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + list(PENDING), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, smoke=args.smoke,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, compress_grads=args.compress_grads,
          device=args.device)


if __name__ == "__main__":
    main()
