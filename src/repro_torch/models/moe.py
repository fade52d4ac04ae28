"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity dispatch.

The port of `repro.models.moe` for one device, `impl="local"`: sort-based
capacity dispatch as one program (route → stable sort by expert → scatter
into an `(E, C, D)` buffer → per-expert SwiGLU → gather back and combine).
What carries over, step for step:
  * the router in float32 (logits, softmax, top-k; `norm_topk` divides by
    `max(sum, 1e-9)`), the gates cast to the activation type;
  * capacity `C = max(8, ceil(n·k/E·capacity_factor))` from the call's own
    token count n, in Python floats; slots past C in an expert (in token
    order: the sort is stable) are dropped to a sentinel row;
  * `y_slot · keep · g` in the activation type; the shared expert and its
    sigmoid gate read the same normed input as the router.
What changes:
  * the counts a segment are a `scatter_add_` of ones into E int64 bins, not
    `torch.bincount`, which reads its input's maximum back to the host (two
    synchronisations a layer); integer adds, so the order does not matter;
  * the combine is deterministic: the slots are put back in token order
    (`index_copy_` by the sort's permutation, each row written once) and each
    token's k rows summed by one reduction, where the reference scatter-adds
    (`.at[t_s].add`); `index_add_` on the card would add with atomics, in
    an order that changes the bits of a bf16 sum from run to run;
  * the expert products are `torch.bmm` over the `(E, C, D)` buffer, as the
    reference's einsums, every expert's weights read whether it got a slot
    or not (a grouped GEMM is later work, ROADMAP.md Queue B).
`moe_loop_ref` is a second, plain version that uses no sort (a loop over
experts); the tests and `chip_smoke.py` hold `moe_block` against it, its
output and its gradients.  Training differentiates `moe_block` by autograd:
the loss is cross-entropy alone, as the reference's (`load_balance_loss` is
defined, and no training loss calls it).  `moe_block.route_log` gets one
entry a layer a forward: a recompute under `checkpoint` (with
`checkpoint_contexts`) routes the same tokens again and logs nothing.
`expert_device_permutation` (host numpy, the paper's placement applied to
expert blocks) is ported.

`impl="ep_shardmap"` is expert parallelism over an engine mesh
(`graph.distributed.EngineMesh`, passed as `moe_block(..., mesh=)`): the
experts, padded with zero experts to a multiple of the `m.ep_axis` size, are
dealt to its engines in blocks of e_l, and the expert stacks arrive laid out
that way, as the reference's `shard_map` `in_specs` take them (`ep_specs`:
P(ep_axis, None, None) over the padded count; `shard_experts` lays them out
with `models.sharding.shard_tensor`, `transformer.shard_params` the model's):
(local engines…, e_l, D, F), one process holding its engines' experts only.
Not `layer_specs`: for experts the axis does not divide (qwen2-moe's 60 on 16)
it splits `d_ff_expert`, which EP's slab cannot use; it stays the reference's.
The tokens are laid over (data axes…, model) in row-major order, padded to a
multiple of the engine count; each engine routes its own tokens and the
reference's two-stage dispatch (`_moe_ep_body`) runs over the mesh's
local-engine axes at once, not a loop over engines: stage 1 sorts each
engine's slots by destination (stable), keeps `Cs` a destination and
exchanges tokens and local expert ids with one `all_to_all` over the model
axis; stage 2 sorts what arrived by local expert, keeps `Ce` an expert, runs
the experts (`torch.bmm` over the local expert slab: every data row's tokens
of an expert in one product, so the slab is read once; in training one
product a data row, so that each row's slab gradient stays apart), and both
stages run back, the gate at the source and each token's k slots summed in
slot order (no atomics).  A padded expert is zero weights, as in the
reference, and gives zero rows.

Training differentiates EP on both mesh backends.  The token batch and the
router are the same on every engine, the expert slab on every engine of a
model column; each enters the per-engine work through `EngineMesh.enter`, so
their gradients are the engines' partial gradients summed in engine order
(the data rows' for the slab), and the exchanges and the final gather carry
their transposes.  Differences: without a mesh, or on a mesh without the
axis, EP raises where the reference runs the local path; `moe_block(...,
mesh=)` takes the whole token batch and hands every process every token's
output (the all-gather the reference's `out_specs` leave to XLA).
`moe_ep_rows` is EP inside the transformer laid out on the mesh
(`models.dense_mesh`): it takes the token rows as the residual lies (under
tp_sp split over the data axes and held once along "model", under "fsdp"
split over every axis) and returns its output the same way.  The engines'
blocks must be the reference's, whose capacities follow each block's token
count: where the rows split over every axis, an engine's own rows are its
block; where they split over every data axis and B_l·S divides over
"model", block i of data row g's own tokens is engine (g, i)'s; anywhere
else the rows are gathered and laid out as `moe_block` lays a whole batch
(padded, contiguous blocks), and each engine takes its own rows of the
output back.  Both entries share `_moe_ep_body` and `ep_capacities`.
Under "fsdp" the expert stacks are laid out ZeRO-3 as the reference's
`layer_specs` lays them (the real experts whole, d_model over ("data",
"model")); `zero3_expert_slabs` gathers one layer's into EP's slab at use,
padded as the reference's `pad_e` pads them, and carries the gradient
back.  `moe_ep_loop_ref` is EP's plain
version: the reference's per-device body for one engine at a time on the
whole expert stacks, the exchanges as indexing, no sort.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (P, MeshRules, axis_if_divisible, gather_dim, own_block, shard_tensor,
                                         unshard_tensor)

__all__ = ["MoEConfig", "IMPLS", "EXPERT_KEYS", "layer_shapes", "layer_specs", "ep_specs", "shard_experts",
           "unshard_experts", "zero3_expert_slabs", "capacity", "ep_capacities", "moe_block", "moe_ep_rows",
           "moe_loop_ref", "moe_ep_loop_ref", "load_balance_loss", "checkpoint_contexts", "expert_device_permutation"]

IMPLS = ("local", "ep_shardmap")
EXPERT_KEYS = ("we_gate", "we_up", "we_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0  # 0 ⇒ no shared expert (olmoe); >0 ⇒ qwen2-moe style
    capacity_factor: float = 1.25
    norm_topk: bool = True  # olmoe normalises top-k probs; qwen2-moe does not
    impl: str = "local"  # "local" | "ep_shardmap" (expert parallelism: moe_block(..., mesh=))
    ep_axis: str = "model"
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3

    def padded_experts(self, ep_size: int) -> int:
        """Experts padded up to a multiple of the EP axis (60 → 64 on 16)."""
        return -(-self.num_experts // ep_size) * ep_size


def layer_shapes(m: MoEConfig, d_model: int) -> dict[str, tuple[int, ...]]:
    shapes = {
        "router": (d_model, m.num_experts),
        "we_gate": (m.num_experts, d_model, m.d_ff_expert),
        "we_up": (m.num_experts, d_model, m.d_ff_expert),
        "we_down": (m.num_experts, m.d_ff_expert, d_model),
    }
    if m.d_ff_shared:
        shapes.update(
            {
                "ws_gate": (d_model, m.d_ff_shared),
                "ws_up": (d_model, m.d_ff_shared),
                "ws_down": (m.d_ff_shared, d_model),
                "ws_sig": (d_model, 1),  # qwen2-moe shared-expert sigmoid gate
            }
        )
    return shapes


def layer_specs(m: MoEConfig, d_model: int, r: MeshRules, *, prefix: int = 0, mesh=None) -> dict:
    """Expert stacks shard E on model when divisible, else fall back to
    sharding the expert FFN dim on model (qwen's 60 experts on a 16-way axis)."""
    e_ax = axis_if_divisible(m.num_experts, r.model, mesh)
    f_ax = None if e_ax is not None else axis_if_divisible(m.d_ff_expert, r.model, mesh)
    pre = [None] * prefix
    specs = {
        "router": P(*pre, axis_if_divisible(d_model, r.fsdp, mesh), None),
        "we_gate": P(*pre, e_ax, axis_if_divisible(d_model, r.fsdp, mesh), f_ax),
        "we_up": P(*pre, e_ax, axis_if_divisible(d_model, r.fsdp, mesh), f_ax),
        "we_down": P(*pre, e_ax, f_ax, axis_if_divisible(d_model, r.fsdp, mesh)),
    }
    if m.d_ff_shared:
        specs.update(
            {
                "ws_gate": r.col_parallel(d_model, m.d_ff_shared, prefix=prefix, mesh=mesh),
                "ws_up": r.col_parallel(d_model, m.d_ff_shared, prefix=prefix, mesh=mesh),
                "ws_down": r.row_parallel(m.d_ff_shared, d_model, prefix=prefix, mesh=mesh),
                "ws_sig": P(*pre, None, None),
            }
        )
    return specs


def ep_specs(m: MoEConfig, *, prefix: int = 0) -> dict:
    """The specs EP takes its expert stacks in: the padded experts split
    over `m.ep_axis` (after `prefix` leading dims, e.g. the stacked layers),
    the rest whole — the reference's `shard_map` `in_specs`."""
    return {k: P(*([None] * prefix), m.ep_axis, None, None) for k in EXPERT_KEYS}


def shard_experts(m: MoEConfig, lp: dict, mesh, *, prefix: int = 0) -> dict:
    """`lp` with its whole expert stacks (`prefix` leading dims, then (E, ·,
    ·)) padded with zero experts to a multiple of the EP axis and laid out on
    `mesh` by `shard_tensor(·, ep_specs(m, prefix=prefix)[k], mesh)`:
    (local engines…, prefix dims…, e_l, ·, ·), this process's experts only.
    The other leaves are passed on as they are."""
    if m.ep_axis not in mesh.shape:
        raise ValueError(f"EP lays its experts out over {m.ep_axis!r}; the mesh has {mesh.axis_names}")
    pad = m.padded_experts(mesh.shape[m.ep_axis]) - m.num_experts
    out = dict(lp)
    for k, spec in ep_specs(m, prefix=prefix).items():
        w = lp[k]
        if pad:
            w = torch.cat([w, w.new_zeros((*w.shape[:prefix], pad, *w.shape[prefix + 1:]))], dim=prefix)
        out[k] = shard_tensor(w, spec, mesh)
    return out


def unshard_experts(m: MoEConfig, lp: dict, mesh, *, prefix: int = 0) -> dict:
    """The inverse of `shard_experts`: the whole stacks of the real experts
    (on "process_group" gathered from every rank)."""
    out = dict(lp)
    for k, spec in ep_specs(m, prefix=prefix).items():
        out[k] = unshard_tensor(lp[k], spec, mesh).narrow(prefix, 0, m.num_experts)
    return out


def zero3_expert_slabs(m: MoEConfig, lp: dict, specs: dict, mesh) -> dict:
    """EP's slab of one layer's expert stacks laid out ZeRO-3: `lp[k]`
    (local engines…, E, ·, ·) laid out by `specs[k]` over its (E, ·, ·)
    (`layer_specs` under "fsdp": the experts whole, one other dim split
    over the rules' fsdp axes, "model" last, or whole).  Returns {k: (local
    engines…, e_l, ·, ·)}, the layout `shard_experts` gives: padded with
    zero experts to `padded_experts(ep)` (the reference's `pad_e`), each
    model engine's e_l experts with every dim whole, held once along the
    other axes.

    The forward moves data only.  On "stacked" the split dim is put back
    together (`gather_dim`, one copy of the stack) and each model engine's
    experts are a view of it.  On "process_group" each engine receives its
    own experts' blocks only: the padded blocks go to their model engines
    by one `all_to_all` over "model", then the other axes' blocks are
    gathered.  The gradient comes back by the transposes: EP enters the
    slab over the data axes (`_ep_engines`), whose backward folds the data
    rows' gradients in engine order; then each engine gets its block of
    the split dim, each expert's rows from the one model engine that holds
    it (nothing is summed over "model"), the padding's dropped."""
    if m.ep_axis not in mesh.shape:
        raise ValueError(f"EP lays its experts out over {m.ep_axis!r}; the mesh has {mesh.axis_names}")
    ep, n, a = mesh.shape[m.ep_axis], len(mesh.axis_names), mesh.axis_index(m.ep_axis)
    e_l = m.padded_experts(ep) // ep
    out = {}
    for k in EXPERT_KEYS:
        w, entries = lp[k], tuple(specs[k]) + (None,) * (3 - len(tuple(specs[k])))
        axes = [() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in entries]
        split = [i for i in (1, 2) if axes[i]]
        if axes[0] or len(split) > 1 or (split and axes[split[0]][-1] != m.ep_axis):
            raise ValueError(f"{k}: not a ZeRO-3 expert stack with {m.ep_axis!r} last in its split (spec {specs[k]})")
        pad = e_l * ep - w.shape[n]
        if pad:
            w = torch.cat([w, w.new_zeros((*w.shape[:n], pad, *w.shape[n + 1:]))], n)
        if mesh.backend == "stacked":
            whole = gather_dim(mesh, w, axes[split[0]], n + split[0]) if split else w
            out[k] = whole.unflatten(n, (ep, e_l)).transpose(a, n).squeeze(n)
        elif split:
            i = split[0]
            w = mesh.all_to_all(w.unflatten(n, (ep, e_l)), m.ep_axis)  # dim n: the sending engine
            w = w.movedim(n, n + i).flatten(n + i, n + i + 1)  # the split dim's blocks of this model row, in order
            out[k] = gather_dim(mesh, w, axes[i][:-1], n + i)
        else:  # whole on every rank: each model engine cuts its experts out, the gradient summed over "model"
            out[k] = own_block(mesh, mesh.enter(w, m.ep_axis), m.ep_axis, n)
    return out


def capacity(m: MoEConfig, n: int) -> int:
    """Slots an expert keeps when `n` tokens are routed in one call."""
    return max(8, int(math.ceil(n * m.top_k / m.num_experts * m.capacity_factor)))


# ------------------------------ routing -----------------------------------


def _router(m: MoEConfig, lp: dict, x: torch.Tensor):
    """x (N, D) → (topk_probs (N,k) in x's type, topk_idx (N,k), full probs (N,E) float32)."""
    return _route(m, x.float() @ lp["router"].float(), x.dtype)


def _route(m: MoEConfig, logits: torch.Tensor, dtype: torch.dtype):
    """float32 logits (…, E) → (topk_probs in `dtype`, topk_idx, full probs)."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p.to(dtype), top_i, probs


def load_balance_loss(probs: torch.Tensor, top_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e f_e·p̄_e (1.0 at perfect balance)."""
    k = top_idx.shape[-1]
    assign = F.one_hot(top_idx, num_experts).float().sum(-2)  # (N, E)
    f = assign.mean(0) / k
    p = probs.mean(0)
    return num_experts * torch.sum(f * p)


def _expert_ffn(we_gate: torch.Tensor, we_up: torch.Tensor, we_down: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, C, D) → (E, C, D) through per-expert SwiGLU."""
    g = torch.bmm(buf, we_gate.to(buf.dtype))
    u = torch.bmm(buf, we_up.to(buf.dtype))
    return torch.bmm(F.silu(g) * u, we_down.to(buf.dtype))


def _sort_dispatch(e_flat: torch.Tensor, num_segments: int):
    """Stable-sort slots by expert id; return (order, position-within-expert,
    counts a segment)."""
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.zeros(num_segments, dtype=torch.long, device=e_flat.device)
    counts.scatter_add_(0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(e_sorted.shape[0], device=e_flat.device) - starts[e_sorted]
    return order, pos, counts


# --------------------------- local (one-program) path ---------------------


@dataclasses.dataclass
class _Plan:
    """Where each of the n·k slots goes: `order` sorts them by expert,
    `dest` (in sorted order) is a row of the (E·C + 1, D) buffer, E·C the
    sentinel of a dropped slot."""

    n: int
    C: int
    order: torch.Tensor
    t_s: torch.Tensor
    dest: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor


def _plan(m: MoEConfig, top_i: torch.Tensor) -> _Plan:
    n, k = top_i.shape
    E = m.num_experts
    C = capacity(m, n)
    e_flat = top_i.reshape(-1)
    order, pos, counts = _sort_dispatch(e_flat, E)
    e_s = e_flat[order]
    t_s = torch.div(order, k, rounding_mode="floor")  # = repeat(arange(n), k)[order]
    keep = pos < C
    dest = torch.where(keep, e_s * C + pos, E * C)
    return _Plan(n, C, order, t_s, dest, keep, counts)


def _dispatch(m: MoEConfig, plan: _Plan, x: torch.Tensor) -> torch.Tensor:
    """x (N, D) → the (E, C, D) expert buffer; unfilled rows are zero."""
    E, C, d = m.num_experts, plan.C, x.shape[1]
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, plan.dest, x[plan.t_s])  # dropped slots all land on the sentinel row
    return buf[: E * C].view(E, C, d)


def _combine(m: MoEConfig, plan: _Plan, y: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """y (E, C, D) → (N, D): each kept slot's output times its gate, summed
    over a token's k slots in top-k order."""
    E, C, d = m.num_experts, plan.C, y.shape[-1]
    g_s = top_p.reshape(-1)[plan.order]
    y_slot = y.reshape(E * C, d)[plan.dest.clamp_max(E * C - 1)]
    y_slot = y_slot * plan.keep[:, None].to(y.dtype) * g_s[:, None]
    y_tok = torch.empty_like(y_slot).index_copy_(0, plan.order, y_slot)  # back to (token, slot) order
    return y_tok.view(plan.n, m.top_k, d).sum(1)


def _moe_local(m: MoEConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Sort-based capacity dispatch as one program.  x: (N, D)."""
    top_p, top_i, _ = _router(m, lp, x)
    plan = _plan(m, top_i)
    if moe_block.route_log is not None:
        moe_block.route_log.append((plan.C, plan.counts))
    buf = _dispatch(m, plan, x)
    y = _expert_ffn(lp["we_gate"], lp["we_up"], lp["we_down"], buf)
    return _combine(m, plan, y, top_p)


# --------------------------- expert-parallel path (impl="ep_shardmap") ----


def ep_capacities(m: MoEConfig, n_l: int, ep: int, e_l: int) -> tuple[int, int]:
    """(Cs, Ce): the slots an engine sends each destination in stage 1 when it
    routes `n_l` tokens, and the slots a local expert keeps in stage 2; the
    reference's Python-float expressions, term for term."""
    Cs = max(8, int(math.ceil(n_l * m.top_k / ep * m.capacity_factor)))
    Ce = max(8, int(math.ceil(ep * Cs / max(e_l, 1) * m.capacity_factor)))
    return Cs, Ce


def _sort_rows(v: torch.Tensor, num_segments: int):
    """`_sort_dispatch` for each row of v (engines, slots) at once: (order,
    position within its segment, counts a segment), each (engines, ·)."""
    _, order = torch.sort(v, dim=1, stable=True)
    v_s = v.gather(1, order)
    counts = torch.zeros((v.shape[0], num_segments), dtype=torch.long, device=v.device)
    counts.scatter_add_(1, v_s, torch.ones_like(v_s))
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(v.shape[1], device=v.device)[None, :] - starts.gather(1, v_s)
    return order, pos, counts


class _EngineRowsTimes(torch.autograd.Function):
    """x (L, n, D) @ w (L, D, E), where w is one weight entered once a local
    engine (`EngineMesh.enter`: every copy the same).  The forward is one
    product over all L·n rows with the first copy: the router's logits
    have the bits of the whole batch through one product, as the local path
    and `moe_ep_loop_ref` route (a batched product rounds otherwise, and a
    near tie in top-k then picks another expert).  The backward keeps each
    engine's weight gradient apart (one batched product), for `enter` to
    sum in engine order."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        L, n, d = x.shape
        return (x.reshape(L * n, d) @ w[0]).view(L, n, -1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        L, n, d = x.shape
        gx = (g.reshape(L * n, -1) @ w[0].T).view(L, n, d) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(x.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return gx, gw


@dataclasses.dataclass
class EpRoute:
    """One EP routing (`moe_block.ep_log`): the capacities and, for each
    local engine, the slots a destination got in stage 1 (engines, ep) and a
    local expert got in stage 2 (engines, e_l + 1; the last column counts the
    empty slots)."""

    Cs: int
    Ce: int
    stage1: torch.Tensor
    stage2: torch.Tensor


def _moe_ep_body(m: MoEConfig, mesh, x: torch.Tensor, router: torch.Tensor, slabs: list, e_l: int) -> torch.Tensor:
    """The reference's per-device body (`_moe_ep_local_body`) for every local
    engine at once.  x (G, M, n_l, D): the local engines' tokens, G over the
    data axes (flattened) and M over the model axis, in that order whatever
    the mesh's axis order; router (G·M, D, E): each engine's copy; slabs: for
    each of the G data rows, (wg, wu, wd) of its M·e_l experts, padded ones
    included (every row's the same weights).  Returns (G, M, n_l, D)."""
    G, M, n_l, d = x.shape
    L, k, ep = G * M, m.top_k, mesh.shape[m.ep_axis]
    dev = x.device
    a, n_axes = mesh.axis_index(m.ep_axis), len(mesh.axis_names)
    dp_local = [s for name, s in zip(mesh.axis_names, mesh.local_shape) if name != m.ep_axis]

    def exchange(t: torch.Tensor) -> torch.Tensor:
        """(L·ep·Cs, …) → the same: block j of engine (g, i) goes to (g, j) along the model axis."""
        rest = t.shape[1:]
        t = t.view(*dp_local, M, ep, Cs, *rest).movedim(n_axes - 1, a)
        t = mesh.all_to_all(t, m.ep_axis).movedim(a, n_axes - 1)
        return t.reshape(L * ep * Cs, *rest)

    xf = x.reshape(L * n_l, d)
    top_p, top_i, _ = _route(m, _EngineRowsTimes.apply(x.reshape(L, n_l, d).float(), router.float()), x.dtype)
    top_p, top_i = top_p.reshape(L, n_l * k), top_i.reshape(L, n_l * k)
    rows = torch.arange(L, device=dev)[:, None]

    # stage 1: route each engine's slots to the engines that own their experts
    dest = torch.div(top_i, e_l, rounding_mode="floor")
    Cs, Ce = ep_capacities(m, n_l, ep, e_l)
    S = ep * Cs
    order, pos, counts1 = _sort_rows(dest, ep)
    keep = pos < Cs
    slot = torch.where(keep, dest.gather(1, order) * Cs + pos, S)  # S: the sentinel of a dropped slot
    into = torch.where(keep, rows * S + slot, L * S).view(-1)  # one sentinel row for every engine
    # each sorted slot's token, from x repeated once a slot: a token's gradient is then its k slots' summed in
    # slot order (a gather of the tokens would scatter-add them, in an order that CPU threads vary)
    x_slots = xf.view(L, n_l, 1, d).expand(L, n_l, k, d).reshape(L * n_l * k, d)
    send_x = torch.zeros((L * S + 1, d), dtype=x.dtype, device=dev)
    send_x.index_copy_(0, into, x_slots[(rows * (n_l * k) + order).view(-1)])
    del x_slots
    send_e = torch.full((L * S + 1,), e_l, dtype=torch.long, device=dev)  # e_l marks an empty slot
    send_e.index_copy_(0, into, (top_i - dest * e_l).gather(1, order).view(-1))
    send_g = torch.zeros((L * S + 1,), dtype=x.dtype, device=dev)
    send_g.index_copy_(0, into, top_p.gather(1, order).view(-1))
    recv_x, recv_e = exchange(send_x[:-1]), exchange(send_e[:-1]).view(L, S)

    # stage 2: group what arrived by local expert, into every local expert's rows (experts, G, Ce)
    order2, pos2, counts2 = _sort_rows(recv_e, e_l + 1)
    e2 = recv_e.gather(1, order2)
    keep2 = (pos2 < Ce) & (e2 < e_l)
    g_of, i_of = torch.div(rows, M, rounding_mode="floor"), rows % M
    n_buf = M * e_l * G * Ce
    dest2 = torch.where(keep2, ((i_of * e_l + e2) * G + g_of) * Ce + pos2, n_buf).view(-1)
    arrived = (rows * S + order2).view(-1)
    buf = torch.zeros((n_buf + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, dest2, recv_x[arrived])
    del recv_x
    buf = buf[:-1].view(M * e_l, G, Ce, d)
    if torch.is_grad_enabled() and any(w.requires_grad for w in slabs[0]):
        # one product a data row: each row's slab gradient apart, for `enter` to fold
        y = torch.stack([_expert_ffn(*slab, buf[:, g]) for g, slab in enumerate(slabs)], 1)
    else:  # every data row's tokens of an expert in one product: the slab read once
        y = _expert_ffn(*slabs[0], buf.view(M * e_l, G * Ce, d))
    y = y.reshape(n_buf, d)
    del buf
    y_recv = torch.empty((L * S, d), dtype=x.dtype, device=dev)
    y_recv.index_copy_(0, arrived, y[dest2.clamp_max(n_buf - 1)] * keep2.view(-1, 1).to(x.dtype))

    # back: the reverse exchange, the gate at the source, each token's k slots summed in slot order
    y_slot = exchange(y_recv).view(L, S, d) * send_g[:-1].view(L, S, 1)
    contrib = y_slot.view(L * S, d)[(rows * S + slot.clamp_max(S - 1)).view(-1)]
    contrib = contrib * (slot < S).view(-1, 1).to(x.dtype)
    y_tok = torch.empty_like(contrib).index_copy_(0, (rows * (n_l * k) + order).view(-1), contrib)
    if moe_block.ep_log is not None:
        moe_block.ep_log.append(EpRoute(Cs, Ce, counts1, counts2))
    return y_tok.view(G, M, n_l, k, d).sum(3)


def _ep_slab_width(m: MoEConfig, lp: dict, mesh) -> int:
    """e_l, the experts an engine holds; raises without a mesh that has
    `m.ep_axis` or where `lp`'s expert stacks are not laid out on it
    (`shard_experts`)."""
    if mesh is None or m.ep_axis not in mesh.shape:
        raise ValueError(f"MoE impl='ep_shardmap' needs a mesh with the {m.ep_axis!r} axis (moe_block(..., "
                         f"mesh=)); got {None if mesh is None else mesh.axis_names}")
    ep = mesh.shape[m.ep_axis]
    e_l = m.padded_experts(ep) // ep
    n_axes, a = len(mesh.axis_names), mesh.axis_index(m.ep_axis)
    want = tuple(mesh.local_shape[i] if i == a else 1 for i in range(n_axes)) + (e_l,)
    got = tuple(lp["we_gate"].shape[:n_axes + 1])
    if got != want or lp["we_gate"].dim() != n_axes + 3:
        raise ValueError(f"EP takes the expert stacks laid out on the mesh (moe.shard_experts, "
                         f"transformer.shard_params): leading dims {want}, got {tuple(lp['we_gate'].shape)}")
    return e_l


def _token_axes(m: MoEConfig, mesh) -> tuple[str, ...]:
    """The axes the reference lays the flat tokens over: the data axes in
    the mesh's order, then the model axis (`act_tokens_sp`, `tok_spec`)."""
    return (*(name for name in mesh.axis_names if name != m.ep_axis), m.ep_axis)


def _ep_engines(m: MoEConfig, lp: dict, x: torch.Tensor, router: torch.Tensor, mesh, e_l: int) -> torch.Tensor:
    """`_moe_ep_body` on the local engines' own tokens x (local engines…,
    n_l, D), each engine's block of the reference's token layout; router
    (1…, D, E), held once along every axis.  Returns (local engines…, n_l,
    D)."""
    n_axes, a = len(mesh.axis_names), mesh.axis_index(m.ep_axis)
    names = _token_axes(m, mesh)[:-1]
    to_body = [mesh.axis_index(name) for name in names] + [a]  # the local engines in (data axes…, model) order
    dp_local = [mesh.local_shape[i] for i in to_body[:-1]]
    G, M = int(np.prod(dp_local)), mesh.local_shape[a]
    n_l, d = x.shape[-2:]

    def per_engine(t: torch.Tensor, axes=None) -> torch.Tensor:
        """A tensor held once along `axes` (None: every axis) as the local
        engines read it, their axes in body order."""
        t = mesh.enter(t, axes)
        return t.permute(*to_body, *range(n_axes, t.dim()))

    xl = x.permute(*to_body, n_axes, n_axes + 1).reshape(G, M, n_l, d)
    rw = per_engine(router).reshape(G * M, *router.shape[n_axes:])
    # each data row's copy of the local engines' expert slab (M·e_l, ·, ·)
    slabs = zip(*(per_engine(lp[key], names).reshape(G, M * e_l, *lp[key].shape[n_axes + 1:]).unbind(0)
                  for key in EXPERT_KEYS))
    out = _moe_ep_body(m, mesh, xl, rw, list(slabs), e_l)
    return out.view(*dp_local, M, n_l, d).movedim(len(dp_local), a)


def _ep_flat(m: MoEConfig, lp: dict, x: torch.Tensor, router: torch.Tensor, mesh, e_l: int) -> torch.Tensor:
    """EP on the flat tokens x (1…, N, D), held once along every axis, as the
    reference lays them out: padded at the end to a multiple of the engine
    count (the padding routed too), split into contiguous blocks over
    (data axes…, model), each engine routing its own.  Returns (1…, N, D),
    every engine's output gathered."""
    n_axes, n_tok, d = len(mesh.axis_names), x.shape[-2], x.shape[-1]
    n_pad = -(-n_tok // mesh.num_engines) * mesh.num_engines  # decode batches can be smaller than the engine count
    if n_pad != n_tok:
        x = torch.cat([x, x.new_zeros((*x.shape[:n_axes], n_pad - n_tok, d))], n_axes)
    axes = _token_axes(m, mesh)
    x = mesh.enter(x)
    for name in axes:  # block (g, i) of the tokens laid out over (data axes…, model): row-major
        x = own_block(mesh, x, name, n_axes)
    out = gather_dim(mesh, _ep_engines(m, lp, x, router, mesh, e_l), axes, n_axes)
    return out.narrow(n_axes, 0, n_tok)


def _moe_ep(m: MoEConfig, lp: dict, x: torch.Tensor, mesh) -> torch.Tensor:
    """Expert parallelism over `mesh`'s `m.ep_axis`.  x: (N, D), the whole
    token batch on every process; `lp`'s expert stacks laid out on the mesh
    (`shard_experts`), its router whole.  Returns (N, D), gathered from
    every engine."""
    e_l = _ep_slab_width(m, lp, mesh)
    lead = (1,) * len(mesh.axis_names)
    out = _ep_flat(m, lp, x.view(*lead, *x.shape), lp["router"].view(*lead, *lp["router"].shape), mesh, e_l)
    return out.reshape(x.shape)


def moe_ep_rows(m: MoEConfig, lp: dict, x: torch.Tensor, router: torch.Tensor, batch: tuple[str, ...],
                mesh) -> torch.Tensor:
    """EP on token rows laid out as `models.dense_mesh` holds its residual:
    x (local engines…, B_l, S, D), the B rows split over the mesh axes
    `batch` (in the mesh's order; empty: every engine holds them all) and
    held once along the others; `lp`'s expert stacks laid out as
    `shard_experts` lays them (or gathered so by `zero3_expert_slabs`);
    router (1…, D, E), whole and held once.  Returns the routed output in
    x's layout.

    The reference routes the flat B·S tokens, padded to a multiple of the
    engine count and split into contiguous blocks over (data axes…, model),
    and sizes each engine's capacities from its block.  Where the rows split
    over all of those axes in that order ("fsdp"), an engine's own rows are
    its block: each routes them in place, and nothing is gathered.  Where
    they split over every data axis and B_l·S divides over "model" (tp_sp),
    engine (g, i)'s block is block i of data row g's own tokens: each engine
    takes it from the rows it holds, and the output is gathered over "model"
    only.  Anywhere else (a one-slot prompt held once along every axis, a
    decode batch smaller than the engine count, a B_l·S that "model" does
    not divide) the rows are gathered over `batch` first, routed as
    `moe_block` routes a whole batch, and each engine takes its own rows of
    the output."""
    e_l = _ep_slab_width(m, lp, mesh)
    n_axes, axes = len(mesh.axis_names), _token_axes(m, mesh)
    b_l, s, d = x.shape[-3:]
    flat = x.reshape(*x.shape[:n_axes], b_l * s, d)
    if tuple(batch) == axes:
        return _ep_engines(m, lp, flat, router, mesh, e_l).reshape(x.shape)
    if tuple(batch) == axes[:-1] and (b_l * s) % mesh.shape[m.ep_axis] == 0:
        own = own_block(mesh, mesh.enter(flat, m.ep_axis), m.ep_axis, n_axes)
        out = _ep_engines(m, lp, own, router, mesh, e_l)
        return gather_dim(mesh, out, (m.ep_axis,), n_axes).reshape(x.shape)
    whole = gather_dim(mesh, flat, tuple(batch), n_axes) if batch else flat
    out = _ep_flat(m, lp, whole, router, mesh, e_l)
    out = out.reshape(*out.shape[:n_axes], -1, s, d)
    if batch:
        out = mesh.enter(out, batch)
        for name in batch:
            out = own_block(mesh, out, name, n_axes)
    return out


# ------------------------------ public block -------------------------------


def _shared_expert(lp: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ lp["ws_gate"].to(x.dtype)
    u = x @ lp["ws_up"].to(x.dtype)
    shared = (F.silu(g) * u) @ lp["ws_down"].to(x.dtype)
    return shared * torch.sigmoid(x @ lp["ws_sig"].to(x.dtype))


def moe_block(m: MoEConfig, lp: dict, x: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D).  Routed experts (+ optional shared expert).
    "local": the B·S tokens are routed together, one capacity for all of
    them; "ep_shardmap": over `mesh` (an `EngineMesh` with the `m.ep_axis`
    axis; without one it raises), each engine routing its share."""
    if m.impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {m.impl!r}; options: {'|'.join(IMPLS)}")
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    routed = _moe_ep(m, lp, flat, mesh) if m.impl == "ep_shardmap" else _moe_local(m, lp, flat)
    out = routed.view(b, s, d)
    if m.d_ff_shared:
        out = out + _shared_expert(lp, x)
    return out


# A list that each local routing appends (C, slots each expert got) to, or None (the default: nothing
# is kept); and one that each EP routing appends an `EpRoute` to.
moe_block.route_log = None
moe_block.ep_log = None


@contextlib.contextmanager
def _route_log_off():
    logs = moe_block.route_log, moe_block.ep_log
    moe_block.route_log = moe_block.ep_log = None
    try:
        yield
    finally:
        moe_block.route_log, moe_block.ep_log = logs


def checkpoint_contexts():
    """`context_fn` of `torch.utils.checkpoint.checkpoint`: the forward logs
    its routings, the recompute in the backward does not, so `route_log`
    holds one entry a layer a forward."""
    return contextlib.nullcontext(), _route_log_off()


def moe_loop_ref(m: MoEConfig, lp: dict, x: torch.Tensor):
    """The plain version of `moe_block`, without the sort: for each expert,
    the slots routed to it in token order, the first C kept, its SwiGLU times
    the gate added into the token's row; then the shared expert.  Returns
    (out (B, S, D), kept (B·S, k) bool: which slots an expert kept)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    n = flat.shape[0]
    top_p, top_i, _ = _router(m, lp, flat)
    C = capacity(m, n)
    out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    kept = torch.zeros(top_i.shape, dtype=torch.bool, device=x.device)
    for e in range(m.num_experts):
        tok, slot = (top_i == e).nonzero(as_tuple=True)  # row-major: token order, one slot a token
        tok, slot = tok[:C], slot[:C]
        kept[tok, slot] = True
        h = flat[tok]
        y = (F.silu(h @ lp["we_gate"][e].to(x.dtype)) * (h @ lp["we_up"][e].to(x.dtype))) @ lp["we_down"][e].to(x.dtype)
        out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    out = out.view(b, s, d)
    if m.d_ff_shared:
        out = out + _shared_expert(lp, x)
    return out, kept


def moe_ep_loop_ref(m: MoEConfig, lp: dict, x: torch.Tensor, mesh):
    """The plain version of impl="ep_shardmap" on `mesh` (read for its shape
    only): the reference's per-device two-stage body run for one engine at a
    time in a Python loop, the all-to-alls as indexing between the engines'
    slots, and no sort: an engine keeps the first `Cs` of its slots for each
    destination in (token, slot) order, an engine the first `Ce` of what
    arrived for each local expert in order of arrival (source engine, then
    slot), and each kept slot's SwiGLU times its gate is added into its
    token's row.  Returns (out (B, S, D), stage-1 slots each destination got
    (engines, ep), stage-2 slots each local expert got (engines, e_l + 1, the
    last column the empty slots)), engines in (data…, model) order, as an
    `EpRoute`'s."""
    b, s, d = x.shape
    k, ep = m.top_k, mesh.shape[m.ep_axis]
    G = mesh.num_engines // ep
    e_l = m.padded_experts(ep) // ep
    flat = x.reshape(b * s, d)
    n = flat.shape[0]
    n_pad = -(-n // (G * ep)) * (G * ep)
    flat = torch.cat([flat, flat.new_zeros((n_pad - n, d))])  # the padding tokens are routed too
    n_l = n_pad // (G * ep)
    Cs, Ce = ep_capacities(m, n_l, ep, e_l)
    top_p, top_i, _ = _router(m, lp, flat)
    out = torch.zeros_like(flat)
    stage1 = torch.zeros((G, ep, ep), dtype=torch.long)
    stage2 = torch.zeros((G, ep, e_l + 1), dtype=torch.long)
    for g in range(G):
        sent = {}  # (source i, destination j) → (tokens, global experts, gates) of the kept slots
        for i in range(ep):
            src = slice((g * ep + i) * n_l, (g * ep + i + 1) * n_l)  # engine (g, i)'s tokens
            tok = torch.arange(n_pad, device=x.device)[src].repeat_interleave(k)
            e, gate = top_i[src].reshape(-1), top_p[src].reshape(-1)  # its slots in (token, slot) order
            for j in range(ep):
                sel = ((e // e_l) == j).nonzero()[:, 0]
                stage1[g, i, j] = sel.numel()
                sel = sel[:Cs]
                sent[i, j] = tok[sel], e[sel], gate[sel]
        for j in range(ep):
            tok, e, gate = (torch.cat(t) for t in zip(*(sent[i, j] for i in range(ep))))
            stage2[g, j, e_l] = ep * Cs - tok.numel()
            for el in range(e_l):
                sel = (e == j * e_l + el).nonzero()[:, 0]
                stage2[g, j, el] = sel.numel()
                sel = sel[:Ce]
                w = j * e_l + el
                if w >= m.num_experts or sel.numel() == 0:
                    continue  # a padded expert: zero weights give zero rows
                h = flat[tok[sel]]
                y = (F.silu(h @ lp["we_gate"][w].to(x.dtype)) * (h @ lp["we_up"][w].to(x.dtype))) @ lp["we_down"][w].to(x.dtype)
                out.index_add_(0, tok[sel], y * gate[sel, None])
    out = out[:n].view(b, s, d)
    if m.d_ff_shared:
        out = out + _shared_expert(lp, x)
    return out, stage1.view(G * ep, ep), stage2.view(G * ep, e_l + 1)


# ---------------------- paper tie-in: expert placement ---------------------


def expert_device_permutation(
    route_counts: np.ndarray,
    ep_size: int,
    *,
    topology=None,
    seed: int = 0,
) -> tuple[np.ndarray, dict[str, float]]:
    """Choose which expert block lands on which model-axis position.

    route_counts: (num_dp_shards, num_experts) token counts from routing
    statistics.  Experts are dealt into `ep_size` blocks in order of load
    (Algorithm 2's degree-sorted cyclic deal, an expert's "degree" being the
    tokens routed to it); block-to-block traffic is what the data-parallel
    shard beside block i sends to the experts of block j; the blocks are
    placed on the interconnect (a `Torus2D` by default) by the paper's
    Algorithm 4 with merged nodes: `greedy_placement`, then the steepest
    2-opt `two_opt_best_move`, kept only if it beats the identity.

    Returns (perm, stats): perm[b] = device position of expert block b; stats
    the average hops of both placements, their ratio and the blocks' load
    balance (max/mean).  Host numpy, bit-equal to the reference.
    """
    from repro_torch.core import placement as placement_lib
    from repro_torch.core.noc import Torus2D

    counts = np.asarray(route_counts, dtype=np.float64)
    n_dp, n_exp = counts.shape
    order = np.argsort(-counts.sum(0), kind="stable")
    block_of = np.empty(n_exp, dtype=np.int64)
    block_of[order] = np.arange(n_exp) % ep_size
    # block traffic: DP shard d (beside block d % ep) → expert block b
    traffic = np.zeros((ep_size, ep_size))
    for d in range(n_dp):
        src_block = d % ep_size
        for b in range(ep_size):
            traffic[src_block, b] += counts[d, block_of == b].sum()
    np.fill_diagonal(traffic, 0.0)
    if topology is None:
        kx = int(np.sqrt(ep_size))
        while ep_size % kx:
            kx -= 1
        topology = Torus2D(kx, ep_size // kx)
    greedy = placement_lib.greedy_placement(traffic, topology, seed=seed)
    placed = placement_lib.two_opt_best_move(greedy, traffic)
    identity = placement_lib.Placement(topology, np.arange(ep_size), "identity")
    h_opt, h_id = placed.average_hops(traffic), identity.average_hops(traffic)
    if h_opt >= h_id:
        placed, h_opt = identity, h_id
    stats = {
        "hops_optimized": float(h_opt),
        "hops_identity": float(h_id),
        "hop_reduction": float(h_id / h_opt) if h_opt else 1.0,
        "load_balance": float(
            np.bincount(block_of, weights=counts.sum(0), minlength=ep_size).max()
            / max(counts.sum() / ep_size, 1e-9)
        ),
    }
    return placed.site.copy(), stats
