"""Optimizer substrate: AdamW, LR schedules, grad clipping, compression.

The port of `repro.train.optim`: a functional API, `adamw(...)` returns
(init, update) over nested dicts of tensors, state a tree parallel to the
params.  The update runs under `torch.no_grad()` and writes the params, the
optimizer state and (when clipping) the grads in place — the counterpart of
the JAX step's `donate_argnums`: at dcn-v2's 418 M parameters a copy of each
would be 1.7 GB more a step.  It returns the same objects.  Details kept
from the reference: `lr_fn(step)` is taken before the increment (so
`cosine_schedule(lr, 10, N)` gives lr 0 at step 0), the global norm is taken
over every leaf, b2 = 0.95, weight decay 0.1 on every parameter.

On an engine mesh (`adamw(..., mesh=, sharded=)`) the norm is the one the
reference's `jit` takes over global arrays: a leaf laid out on the mesh
(`sharded`: its path and spec) adds the squares of each engine block it is
split into, each block once, and a leaf held whole counts once, since every
process holds the same one.  The blocks' norms are taken one block at a
time and put together in engine order (gathered over the split axes on
"process_group"), so both mesh backends scale by the same bits.

`int8_compress`: symmetric per-tensor int8 quantisation with error feedback
(what the all-reduce of a data-parallel step would carry).
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from repro_torch.train.pytree import tree_leaves, tree_leaves_with_path, tree_map

__all__ = [
    "Optimizer",
    "adamw",
    "sgd",
    "cosine_schedule",
    "linear_warmup",
    "clip_by_global_norm",
    "int8_compress",
    "Int8State",
]

PyTree = typing.Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: typing.Callable[[PyTree], PyTree]
    update: typing.Callable[[PyTree, PyTree, PyTree, int], tuple[PyTree, PyTree]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def cosine_schedule(base_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog)))

    return lr


def linear_warmup(base_lr: float, warmup: int):
    return lambda step: base_lr * min(float(step) + 1, warmup) / warmup


def _leaf_norm(g: torch.Tensor, mesh, spec) -> torch.Tensor:
    """‖g‖ of a whole leaf; of a leaf laid out on `mesh` by `spec`, the norm
    of its blocks' norms over the engines that split it, in engine order."""
    if spec is None:
        return torch.linalg.vector_norm(g.float())
    n = len(mesh.axis_names)
    split = {a for part in spec if part is not None for a in ((part,) if isinstance(part, str) else part)}
    blocks = torch.stack([torch.linalg.vector_norm(b.float()) for b in g.reshape(*g.shape[:n], -1).flatten(0, n - 1)])
    blocks = blocks.view(g.shape[:n])
    for axis in mesh.axis_names:
        if axis in split:
            blocks = mesh.all_gather(blocks, axis)
    return torch.linalg.vector_norm(blocks.reshape(-1))


def clip_by_global_norm(grads: PyTree, max_norm: float, *, mesh=None,
                        sharded: dict | None = None) -> tuple[PyTree, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / ‖grads‖) — in place — and return
    (grads, the global norm).  The norm stays on the device: no host sync.
    `sharded`: {leaf path: spec} of the leaves laid out on `mesh` (the
    module's docstring says how they count)."""
    sharded = sharded or {}
    with torch.no_grad():
        leaves = tree_leaves_with_path(grads)
        norms = torch.stack([_leaf_norm(g, mesh, sharded.get(path)) for path, g in leaves])
        gn = torch.linalg.vector_norm(norms)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        for _, g in leaves:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.float() * scale)
    return grads, gn


def adamw(
    lr: typing.Callable | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float | None = 1.0,
    mu_dtype: torch.dtype = torch.float32,
    mesh=None,
    sharded: dict | None = None,
) -> Optimizer:
    """AdamW; `mesh`, `sharded`: the engine mesh the params live on and
    {leaf path: spec} of those laid out on it, for the global norm."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {
            "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=mu_dtype, device=p.device), params),
            "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        }

    def update(grads, state, params, step):
        with torch.no_grad():
            if max_grad_norm is not None:
                grads, _ = clip_by_global_norm(grads, max_grad_norm, mesh=mesh, sharded=sharded)
            stepf = float(step) + 1.0
            bc1 = 1.0 - b1**stepf
            bc2 = 1.0 - b2**stepf
            lr_t = float(lr_fn(step))
            for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                    tree_leaves(state["mu"]), tree_leaves(state["nu"])):
                g32 = g.float()
                if mu.dtype == torch.float32:
                    m32 = mu.mul_(b1).add_(g32, alpha=1 - b1)
                else:
                    m32 = mu.float().mul_(b1).add_(g32, alpha=1 - b1)
                    mu.copy_(m32)
                nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
                delta = (m32 / bc1).div_((nu / bc2).sqrt_().add_(eps))
                delta.add_(p.float(), alpha=weight_decay).mul_(lr_t)
                if p.dtype == torch.float32:
                    p.sub_(delta)
                else:
                    p.copy_(p.float() - delta)
        return params, state

    return Optimizer(init, update)


def sgd(lr: typing.Callable | float, *, momentum: float = 0.9) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params, step):
        lr_t = float(lr_fn(step))
        with torch.no_grad():
            for p, g, m in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"])):
                m.mul_(momentum).add_(g.float())
                if p.dtype == torch.float32:
                    p.sub_(lr_t * m)
                else:
                    p.copy_(p.float() - lr_t * m)
        return params, state

    return Optimizer(init, update)


# ------------------------- gradient compression ----------------------------


@dataclasses.dataclass
class Int8State:
    residual: PyTree  # error-feedback buffer, same tree as grads


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_compress(grads: PyTree, state: Int8State) -> tuple[PyTree, Int8State]:
    """Quantise (grad + residual) per tensor to int8; return the dequantised
    value (what the all-reduce would carry) and the new residual.  Error
    feedback keeps the *cumulative* update unbiased."""
    residuals = []

    def comp(g, r):
        v = g.float() + r
        q, scale = _quantize(v)
        deq = q.float() * scale
        residuals.append(v - deq)
        return deq.to(g.dtype)

    with torch.no_grad():
        deq = tree_map(comp, grads, state.residual)
    pending = iter(residuals)  # tree_map visits the leaves in the same order
    return deq, Int8State(tree_map(lambda _: next(pending), grads))
