"""End-to-end driver, in the PyTorch port: train a ~100M-param llama-family
model on the synthetic token pipeline with the full production loop (AdamW
+ cosine, grad clip, int8 gradient compression, async checkpointing,
preemption-safe resume).

    PYTHONPATH=src python examples/torch_train_lm_e2e.py --steps 300 [--device cpu]

The flags and lines of `examples/train_lm_e2e.py`, through
`repro_torch.train`, on the card unless `--device cpu` is given
(`--width 768 --layers 12` ≈ 100M params; the default is budget-scaled).
Float32 activations: every step runs the attention kernel's forward twice a
layer (forward and recompute) and its backward once.  A second call with
the same `--ckpt-dir` and more `--steps` resumes from the last checkpoint.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.data.pipeline import Prefetcher, TokenPipeline, to_device
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import MoEConfig
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.loop import TrainLoop, make_train_step
from repro_torch.train.optim import adamw, cosine_schedule
from repro_torch.train.pytree import tree_leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--moe", action="store_true", help="8-expert top-2 MoE FFN")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None, help="the model's device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = tfm.TransformerConfig(
        "e2e", n_layers=args.layers, d_model=args.width, n_heads=max(4, args.width // 64),
        n_kv_heads=max(2, args.width // 128), d_ff=4 * args.width, vocab=args.vocab,
        dtype=torch.float32,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=args.width,
                      d_ff_shared=args.width) if args.moe else None,
    )
    params = tfm.init_params(cfg, 0, device=device)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n/1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab})")

    opt = adamw(cosine_schedule(3e-4, 20, args.steps))
    init_state, step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt, compress=True)
    loop = TrainLoop(step, checkpointer=Checkpointer(args.ckpt_dir, every=100), log_every=10)
    data = Prefetcher(to_device(b, device) for b in TokenPipeline(cfg.vocab, args.seq, args.batch))
    try:
        state = loop.run(init_state(params), data, num_steps=args.steps)
    finally:
        data.close()
    print(f"done at step {int(state.step)}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
