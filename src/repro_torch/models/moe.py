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
Not ported: `impl="ep_shardmap"` (expert parallelism over a mesh) and
`layer_specs`, ROADMAP.md Queue A 9.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["MoEConfig", "layer_shapes", "capacity", "moe_block", "moe_loop_ref", "load_balance_loss",
           "checkpoint_contexts", "expert_device_permutation"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0  # 0 ⇒ no shared expert (olmoe); >0 ⇒ qwen2-moe style
    capacity_factor: float = 1.25
    norm_topk: bool = True  # olmoe normalises top-k probs; qwen2-moe does not
    impl: str = "local"  # "local"; "ep_shardmap" is not ported (ROADMAP.md Queue A 9)
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


def capacity(m: MoEConfig, n: int) -> int:
    """Slots an expert keeps when `n` tokens are routed in one call."""
    return max(8, int(math.ceil(n * m.top_k / m.num_experts * m.capacity_factor)))


# ------------------------------ routing -----------------------------------


def _router(m: MoEConfig, lp: dict, x: torch.Tensor):
    """x (N, D) → (topk_probs (N,k) in x's type, topk_idx (N,k), full probs (N,E) float32)."""
    logits = x.float() @ lp["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p.to(x.dtype), top_i, probs


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


# ------------------------------ public block -------------------------------


def _shared_expert(lp: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ lp["ws_gate"].to(x.dtype)
    u = x @ lp["ws_up"].to(x.dtype)
    shared = (F.silu(g) * u) @ lp["ws_down"].to(x.dtype)
    return shared * torch.sigmoid(x @ lp["ws_sig"].to(x.dtype))


def moe_block(m: MoEConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D).  Routed experts (+ optional shared expert);
    the B·S tokens are routed together, one capacity for all of them."""
    if m.impl != "local":
        raise NotImplementedError(
            f"MoE impl={m.impl!r}: expert parallelism is not ported (ROADMAP.md Queue A 9); use impl='local'"
        )
    b, s, d = x.shape
    out = _moe_local(m, lp, x.reshape(b * s, d)).view(b, s, d)
    if m.d_ff_shared:
        out = out + _shared_expert(lp, x)
    return out


# A list that each routing appends (C, slots each expert got) to, or None (the default: nothing is kept).
moe_block.route_log = None


@contextlib.contextmanager
def _route_log_off():
    log, moe_block.route_log = moe_block.route_log, None
    try:
        yield
    finally:
        moe_block.route_log = log


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
