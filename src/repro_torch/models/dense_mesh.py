"""Megatron tensor parallelism and FSDP for the transformer on an engine mesh.

What GSPMD makes of `repro.models.transformer.loss_fn` under `jax.jit` on a
("data", "model") mesh with `cfg.rules`: Megatron's column- and row-parallel
products on "model" under `MeshRules(strategy="tp_sp")`, ZeRO-3 under
"fsdp".  Eager PyTorch has no GSPMD, so the per-engine work is written here by
hand, once, over the mesh's local-engine axes (as `moe._moe_ep_body` is), and
both mesh backends run it with the same bits.  `transformer.forward`,
`loss_fn`, `prefill` and the decode steps call it for a dense config given a
mesh, and for an MoE config with impl="ep_shardmap" under either strategy:
the same layer, its FFN the reference's `moe_block` under `shard_map`
(`_moe_ffn`: EP over "model" on each engine's own tokens, the shared expert
as the dense FFN's products, Megatron TP or ZeRO-3), its KV cache laid out
as a dense model's.

Layout.  Every leaf is laid out by `transformer.shard_params`
(`sharding.shard_tensor` with `transformer.param_specs`): (local engines…,
[L,] block…).  Every activation carries the local-engine axes too, with the
set of mesh axes it differs along; along the others it is held once (size 1
on "stacked", the same on every rank of the row on "process_group").  The
token rows are split over `rules.batch` where the batch divides over it
(`axis_if_divisible`), else every engine takes them all.

A layer, term by term:
  * FSDP.  A weight dim split over the rules' fsdp axes is gathered
    (`EngineMesh.all_gather`; on "stacked" the reshape that reassembles the
    dim), then entered, over the same axes, into the engines' work: its
    gradient is the engines' terms folded in engine order, then each engine's
    own block (the gather's transpose), a reduce-scatter.  The gathers sit
    inside the layer's `checkpoint`, so the recompute gathers again.
  * Megatron's f and g.  The residual, held once along "model", enters the
    column-parallel products (wq/wk/wv, w_gate/w_up, lm_head) through
    `EngineMesh.enter(x, "model")`; the row-parallel partials (wo, w_down)
    are summed by `EngineMesh.psum(·, "model")`, whose backward passes the
    cotangent through.  Nothing else sums a gradient over engines.
  * Attention on each engine's own heads where both head counts divide over
    "model": on "stacked" every engine's heads are folded into the kernel's
    batch, one `flash_attention` launch a layer a pass.  Where the columns are
    split but the heads do not divide, the split q/k/v are gathered over
    "model", attention runs once a data row (held once along "model"), and
    its output enters wo's row blocks through `enter`, each engine taking its
    own.
  * The embedding, split by vocab over "model": each engine looks up the ids
    in its range, 0 for the rest, summed over "model" (one non-zero term and
    zeros: bit-equal to the gather), then cast to `cfg.dtype`.
  * The loss.  Where the logits are split by vocab, Megatron's vocab-parallel
    cross-entropy: the row max (no gradient) and the sum of exponentials
    across the model engines, the gold logit from the engine that holds it;
    the logits are never gathered.  The engines' nll sums are folded over the
    batch axes and divided by the valid count: the same value on every engine.

A weight held once along axes that the rows are split over is used by every
engine there.  `_EngineMatmul` and `_EngineLookup` compute that without a copy
of the weight an engine (16 copies of lm_head would not fit beside the
training state): the forward is one product a weight block over every
engine's rows, the backward makes each engine's gradient and folds them one at
a time in the order of `EngineMesh.enter`'s backward (one axis at a time in
the mesh's order, along each in engine order), then `psum`s over the entered
axes (a no-op on "stacked", the fold across ranks on "process_group").

The residual stays held once along "model" between the blocks: a psum, where
Megatron-SP reduce-scatters it over the sequence and gathers it again (the
reference's `act_btd`): GSPMD's layout, the same function.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_rope, gqa_attention, rms_norm, rope_table
from repro_torch.models.sharding import P, axis_if_divisible, gather_dim, own_block, shard_tensor, unshard_tensor

__all__ = ["forward", "loss_fn", "prefill", "decode"]

Tensor = torch.Tensor


def _axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes (empty: whole)."""
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _ordered(mesh, axes) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in axes)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What every layer reads: the mesh, the params' specs, the axes the
    token rows are split over (empty: whole on every engine), the rules'
    fsdp axes and tensor-parallel axis (None under "fsdp" or without it in
    the mesh), and the FFN block (`_ffn`, or `_moe_ffn` with its config)."""

    mesh: object
    specs: dict
    batch: tuple[str, ...]
    fsdp: frozenset
    tp: str | None
    ffn: object


def _plan(cfg, mesh, specs: dict, n_rows: int) -> _Plan:
    r = cfg.rules
    batch = _ordered(mesh, r.batch)
    batch = tuple(axis_if_divisible(n_rows, batch, mesh) or ()) if batch else ()
    tp = r.model if r.model in mesh.shape else None
    ffn = _ffn if cfg.moe is None else functools.partial(_moe_ffn, cfg.moe)
    return _Plan(mesh, specs, batch, frozenset(_axes(r.fsdp)), tp, ffn)


# ------------------------------ collectives ---------------------------------


def _by_block(t: Tensor, lw: tuple, n: int) -> tuple[Tensor, list, torch.Size]:
    """`t` (local engines…, rest…) as (W, E, rest…): W over the local axes
    along which a weight of local shape `lw` differs, E over the others, each
    row-major; with the permutation and the permuted shape that undo it."""
    w_dims = [i for i in range(n) if lw[i] > 1]
    e_dims = [i for i in range(n) if lw[i] == 1]
    order = w_dims + e_dims + list(range(n, t.dim()))
    tp = t.permute(order)
    nw = int(np.prod([t.shape[i] for i in w_dims]))
    return tp.reshape(nw, -1, *t.shape[n:]), order, tp.shape


def _unblock(t: Tensor, order: list, pshape: tuple) -> Tensor:
    """The inverse of `_by_block`; dims past `order`'s stay last."""
    t = t.reshape(pshape)
    return t.permute(*np.argsort(order).tolist(), *range(len(order), t.dim()))


def _nested_fold(term, sizes: list[int], level: int | None = None, base: int = 0) -> Tensor:
    """Σ term(e) over the grid of `sizes` (e its row-major flat index), the
    first axis folded first and along each axis in index order: the order of
    `EngineMesh.enter`'s backward, one term alive at a time.  (A recursion
    of the module's function, not of a closure: a closure that calls itself
    is a reference cycle, and would keep `term`'s tensors alive until the
    cyclic collector runs.)"""
    level = len(sizes) - 1 if level is None else level
    if level < 0:
        return term(base)
    stride = int(np.prod(sizes[level + 1:]))
    out = None
    for c in range(sizes[level]):
        t = _nested_fold(term, sizes, level - 1, base + c * stride)
        out = t if out is None else out + t
    return out


class _EngineMatmul(torch.autograd.Function):
    """Each engine's x @ w.to(x.dtype): x (local engines…, rows…, k), w
    (local engines…, k, n) held once along the `entered` axes (size 1 there)
    and differing along the others as x does.  Forward: one product a weight
    block over every engine's rows.  Backward: dx likewise; dw each engine's
    xᵀ·dy in x's type, cast to w's, folded over the engines that share a block
    in `enter`'s order, then `psum`med over `entered` (the ranks' fold on
    "process_group", a no-op on "stacked"): the bits of `EngineMesh.enter`
    followed by each engine's own cast and product."""

    @staticmethod
    def forward(ctx, x, w, mesh, entered):
        n = len(mesh.axis_names)
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.entered = mesh, entered
        xb, order, pshape = _by_block(x, w.shape[:n], n)
        wb = w.to(x.dtype).reshape(-1, *w.shape[n:])
        y = torch.bmm(xb.reshape(xb.shape[0], -1, x.shape[-1]), wb)
        return _unblock(y, order, (*pshape[:-1], wb.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh, n = ctx.mesh, len(ctx.mesh.axis_names)
        lw = w.shape[:n]
        gb, order, pshape = _by_block(g, lw, n)
        nw, k, m = gb.shape[0], x.shape[-1], g.shape[-1]
        gx = gw = None
        if ctx.needs_input_grad[0]:
            wb = w.to(x.dtype).reshape(-1, *w.shape[n:])
            gx = _unblock(torch.bmm(gb.reshape(nw, -1, m), wb.transpose(1, 2)), order, (*pshape[:-1], k))
        if ctx.needs_input_grad[1]:
            xb = _by_block(x, lw, n)[0]

            def term(e: int) -> Tensor:
                return torch.bmm(xb[:, e].reshape(nw, -1, k).transpose(1, 2), gb[:, e].reshape(nw, -1, m)).to(w.dtype)

            gw = _nested_fold(term, [x.shape[i] for i in range(n) if lw[i] == 1]).view(w.shape)
            for a in ctx.entered:
                gw = mesh.psum(gw, a)
        return gx, gw, None, None


class _EngineLookup(torch.autograd.Function):
    """Each engine's rows of `table` (local engines…, V_l, D) for `ids`
    (local engines…, rows…; the output's local shape) less `offset` (the
    first id of the engine's vocab block): 0 where that falls outside [0,
    V_l).  The table is held once along the `entered` axes.  Backward: each
    engine's rows' cotangents summed into its block (`index_put_` with
    accumulate: deterministic), folded and `psum`med as `_EngineMatmul`'s
    dw."""

    @staticmethod
    def forward(ctx, table, ids, offset, mesh, entered):
        n, rows = len(mesh.axis_names), table.shape[-2]
        loc = ids - offset
        ok = (loc >= 0) & (loc < rows)
        idx, order, pshape = _by_block(loc.clamp(0, rows - 1), table.shape[:n], n)
        base = torch.arange(idx.shape[0], device=ids.device).view(-1, *([1] * (idx.dim() - 1))) * rows
        flat = (idx + base).reshape(-1)
        ctx.save_for_backward(flat, ok)
        ctx.mesh, ctx.entered, ctx.table_shape, ctx.ne = mesh, entered, table.shape, idx.shape[1]
        out = table.reshape(-1, table.shape[-1]).index_select(0, flat)
        out = _unblock(out.view(*idx.shape, -1), order, (*pshape, table.shape[-1]))
        return torch.where(ok[..., None], out, out.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        flat, ok = ctx.saved_tensors
        mesh, n, shape = ctx.mesh, len(ctx.mesh.axis_names), ctx.table_shape
        gb = _by_block(torch.where(ok[..., None], g, g.new_zeros(())), shape[:n], n)[0]
        nw, d = gb.shape[0], shape[-1]
        idx = flat.view(nw, ctx.ne, -1)

        def term(e: int) -> Tensor:  # index_put_'s accumulate sorts on CUDA (index_add_'s atomics do not)
            buf = torch.zeros((nw * shape[-2], d), dtype=g.dtype, device=g.device)
            return buf.index_put_((idx[:, e].reshape(-1),), gb[:, e].reshape(-1, d), accumulate=True)

        sizes = [s for s, w in zip(ok.shape[:n], shape[:n]) if w == 1]
        gt = _nested_fold(term, sizes).view(shape)
        for a in ctx.entered:
            gt = mesh.psum(gt, a)
        return gt, None, None, None, None


# ------------------------------ the engines' work -----------------------------


def _weight(plan: _Plan, w: Tensor, spec) -> tuple[Tensor, frozenset]:
    """A laid-out weight (local engines…, block…) and its spec over the
    block's dims: its dims split over fsdp axes gathered.  Returns the weight
    and the axes it still differs along (tensor-parallel only)."""
    n = len(plan.mesh.axis_names)
    varying = set()
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes and set(axes) <= plan.fsdp:
            w = gather_dim(plan.mesh, w, axes, n + dim)
        else:
            varying |= set(axes)
    return w, frozenset(varying)


def _matmul(plan: _Plan, x: Tensor, x_axes: frozenset, w: Tensor, w_axes: frozenset) -> tuple[Tensor, frozenset]:
    """Each engine's x @ w: x enters along the axes only w differs along
    (Megatron's f), w along those only x differs along."""
    need = _ordered(plan.mesh, w_axes - x_axes)
    if need:
        x = plan.mesh.enter(x, need)
    return _EngineMatmul.apply(x, w, plan.mesh, _ordered(plan.mesh, x_axes - w_axes)), x_axes | w_axes


def _fan_out(plan: _Plan, x: Tensor, x_axes: frozenset, weights: list) -> list:
    """x times each (w, w_axes) of `weights`, x entered once along the axes
    the split weights differ along and it does not; an unsplit weight takes x
    as it is."""
    need = _ordered(plan.mesh, frozenset().union(*(wa for _, wa in weights)) - x_axes)
    xe = plan.mesh.enter(x, need) if need else x
    out = []
    for w, wa in weights:
        src, src_axes = (xe, x_axes | frozenset(need)) if wa - x_axes else (x, x_axes)
        out.append(_matmul(plan, src, src_axes, w, wa))
    return out


def _scale(plan: _Plan, s: Tensor, x: Tensor, x_axes: frozenset) -> Tensor:
    """A replicated norm scale (1…, D) entered along the axes x differs along,
    shaped to broadcast over x's rows."""
    n = len(plan.mesh.axis_names)
    axes = _ordered(plan.mesh, x_axes)
    s = plan.mesh.enter(s, axes) if axes else s
    return s.reshape(*s.shape[:n], *([1] * (x.dim() - n - 1)), s.shape[-1])


def _psum_tp(plan: _Plan, y: Tensor, y_axes: frozenset, x_axes: frozenset) -> Tensor:
    """Megatron's g: the row-parallel partials summed over the tensor-parallel
    axis where the residual is held once along it."""
    if plan.tp is not None and plan.tp in y_axes - x_axes:
        y = plan.mesh.psum(y, plan.tp)
    return y


def _attention(cfg, plan: _Plan, x: Tensor, x_axes: frozenset, lp: dict, attend) -> Tensor:
    """The attention block: `attend(q, k, v)` on each engine's q/k/v (local
    engines…, B_l, S, heads, dh) before RoPE, returning q's shape (the
    causal forward's `_causal`, prefill's `_prompt_attention`, decode's
    `_decode_attention`)."""
    mesh, specs, n = plan.mesh, plan.specs["layers"], len(plan.mesh.axis_names)
    h = rms_norm(x, _scale(plan, lp["attn_norm"], x, x_axes))
    qkv = _fan_out(plan, h, x_axes, [_weight(plan, lp[k], specs[k][1:]) for k in ("wq", "wk", "wv")])
    size = mesh.shape[plan.tp] if plan.tp else 1
    heads_local = (plan.tp is not None and all(plan.tp in a for _, a in qkv)
                   and cfg.n_heads % size == 0 and cfg.n_kv_heads % size == 0)
    if not heads_local:  # the split columns gathered over "model": attention once a data row
        qkv = [(gather_dim(mesh, t, (plan.tp,), t.dim() - 1), a - {plan.tp}) if plan.tp in a else (t, a)
               for t, a in qkv]
    (q, qa), (k, _), (v, _) = qkv
    out = attend(*(t.unflatten(-1, (-1, cfg.head_dim)) for t in (q, k, v))).flatten(-2)
    wo, wa = _weight(plan, lp["wo"], specs["wo"][1:])
    if plan.tp is not None and plan.tp in wa - qa:  # wo's row blocks: each engine its own columns
        out = own_block(mesh, mesh.enter(out, plan.tp), plan.tp, out.dim() - 1)
        qa = qa | {plan.tp}
    y, ya = _matmul(plan, out, qa, wo, wa)
    return _psum_tp(plan, y, ya, x_axes)


def _folded(t: Tensor) -> Tensor:
    """(local engines…, B_l, S, heads, dh) → (engines · B_l, S, heads, dh):
    every engine's rows in the kernel's batch."""
    return t.reshape(-1, *t.shape[-3:])


def _flash(cfg, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal attention from position 0 over every engine's rows and heads
    (after RoPE), one `flash_attention` launch."""
    out = flash_attention(_folded(q), _folded(k), _folded(v), causal=True, q_offset=0, impl=cfg.attn_impl,
                          block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
                          skip_masked_blocks=cfg.attn_skip_masked_blocks)
    return out.reshape(q.shape)


def _causal(cfg, cos, sin, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    return _flash(cfg, apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)


def _ffn(plan: _Plan, x: Tensor, x_axes: frozenset, lp: dict) -> Tensor:
    specs = plan.specs["layers"]
    h = rms_norm(x, _scale(plan, lp["mlp_norm"], x, x_axes))
    (g, ga), (u, _) = _fan_out(plan, h, x_axes, [_weight(plan, lp[k], specs[k][1:]) for k in ("w_gate", "w_up")])
    y, ya = _matmul(plan, F.silu(g) * u, ga, *_weight(plan, lp["w_down"], specs["w_down"][1:]))
    return _psum_tp(plan, y, ya, x_axes)


def _moe_ffn(m, plan: _Plan, x: Tensor, x_axes: frozenset, lp: dict) -> Tensor:
    """The MoE block on `mlp_norm`'s output: the routed experts by EP over
    "model" on each engine's own tokens (`moe.moe_ep_rows`), the router
    gathered whole as `param_specs` lays it (float32, as `cast_params` keeps
    it); the expert stacks as EP's slab (tp_sp), or ZeRO-3 ("fsdp") and
    gathered into it here (`moe.zero3_expert_slabs`: inside the layer's
    `checkpoint`, so the recompute gathers again); qwen2-moe's
    sigmoid-gated shared expert by `_ffn`'s products (Megatron TP: ws_gate/
    ws_up column-parallel, ws_down row-parallel and summed over "model";
    ZeRO-3: each gathered), its gate ws_sig replicated."""
    specs = plan.specs["layers"]
    h = rms_norm(x, _scale(plan, lp["mlp_norm"], x, x_axes))
    router, _ = _weight(plan, lp["router"], specs["router"][1:])
    if _axes(specs["we_gate"][1]) != (m.ep_axis,):  # ZeRO-3 stacks: the experts whole
        lp = {**lp, **moe_lib.zero3_expert_slabs(m, lp, {k: specs[k][1:] for k in moe_lib.EXPERT_KEYS}, plan.mesh)}
    out = moe_lib.moe_ep_rows(m, lp, h, router, plan.batch, plan.mesh)
    if m.d_ff_shared:
        (g, ga), (u, _) = _fan_out(plan, h, x_axes, [_weight(plan, lp[k], specs[k][1:]) for k in ("ws_gate", "ws_up")])
        y, ya = _matmul(plan, F.silu(g) * u, ga, *_weight(plan, lp["ws_down"], specs["ws_down"][1:]))
        # the gate, one dot product a row in float32 (a one-column BLAS product rounds by the row count, which
        # differs between the backends' engines); entered as a norm scale is.  Its sigmoid is taken along each
        # row: a CPU elementwise op vectorizes a contiguous tensor by its whole count, so a one-column tensor's
        # last few entries, which differ with the engines' rows, would round otherwise
        sig = _scale(plan, _weight(plan, lp["ws_sig"], specs["ws_sig"][1:])[0][..., 0], h, x_axes)
        gate = (h.float() * sig.float()).sum(-1, keepdim=True).to(h.dtype)
        y = _psum_tp(plan, y, ya, x_axes)
        out = out + y * torch.sigmoid(gate.expand_as(y))
    return out


def _layer(cfg, plan: _Plan, x: Tensor, x_axes: frozenset, lp: dict, attend) -> Tensor:
    x = x + _attention(cfg, plan, x, x_axes, lp, attend)
    return x + plan.ffn(plan, x, x_axes, lp)


def _rows(plan: _Plan, t) -> Tensor:
    """A (B, S) tensor of the batch as the engines take it: (local engines…,
    B_l, S), split over the batch axes."""
    t = torch.as_tensor(t, device=plan.mesh.device)
    return shard_tensor(t, P(plan.batch or None, None), plan.mesh)


def _tp_offset(plan: _Plan, rows: int, axes: frozenset, device) -> Tensor:
    """Each local engine's first id of its vocab block (0 where the vocab is
    whole), shaped to broadcast over (local engines…, rows…)."""
    n = len(plan.mesh.axis_names)
    if plan.tp is None or plan.tp not in axes:
        return torch.zeros((1,) * (n + 2), dtype=torch.long, device=device)
    shape = [1] * (n + 2)
    shape[plan.mesh.axis_index(plan.tp)] = -1
    return (torch.as_tensor(plan.mesh.local_coords(plan.tp), device=device) * rows).view(shape)


def _embed(cfg, plan: _Plan, table: Tensor, ids: Tensor, axes: frozenset) -> Tensor:
    """The token rows' embeddings (local engines…, B_l, S, D) in `cfg.dtype`,
    held once along "model"."""
    mesh, n = plan.mesh, len(plan.mesh.axis_names)
    w, wa = _weight(plan, table, plan.specs["embed"])
    local = [max(w.shape[i], ids.shape[i]) for i in range(n)]
    out = _EngineLookup.apply(w, ids.expand(*local, *ids.shape[n:]), _tp_offset(plan, w.shape[-2], wa, ids.device),
                              mesh, _ordered(mesh, axes - wa))
    for a in _ordered(mesh, wa):
        out = mesh.psum(out, a)
    return out.to(cfg.dtype)


def _embedded(cfg, plan: _Plan, params: dict, tokens) -> tuple[Tensor, frozenset]:
    """The token rows' embeddings (local engines…, B_l, S, D) and the axes
    they differ along (the batch's)."""
    ids = _rows(plan, tokens).long()
    axes = frozenset(plan.batch)
    return _embed(cfg, plan, params["embed"], ids, axes), axes


def _head(cfg, plan: _Plan, params: dict, x: Tensor, axes: frozenset) -> tuple[Tensor, frozenset, frozenset]:
    """Each engine's logits (local engines…, B_l, S, V_l) of the residual
    `x`, the axes they differ along and the vocab's."""
    h = rms_norm(x, _scale(plan, params["final_norm"], x, axes))
    if cfg.tie_embeddings:
        head, ha = _weight(plan, params["embed"], plan.specs["embed"])
        head = head.transpose(-1, -2)
    else:
        head, ha = _weight(plan, params["lm_head"], plan.specs["lm_head"])
    logits, la = _matmul(plan, h, axes, head, ha)
    return logits, la, ha


def _whole_logits(plan: _Plan, logits: Tensor, vocab: frozenset) -> Tensor:
    """(B, S, V) on every process from each engine's (local engines…, B_l, S, V_l)."""
    return unshard_tensor(logits, P(plan.batch or None, None, _ordered(plan.mesh, vocab) or None), plan.mesh)


def _logits(cfg, plan: _Plan, params: dict, layers: list, tokens) -> tuple[Tensor, frozenset, frozenset, frozenset]:
    """Each engine's logits (local engines…, B_l, S, V_l), the axes they
    differ along, the batch's and the vocab's."""
    x, axes = _embedded(cfg, plan, params, tokens)
    cos, sin = rope_table(x.shape[-2], cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    attend = functools.partial(_causal, cfg, cos, sin)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:
            x = checkpoint(_layer, cfg, plan, x, axes, lp, attend, use_reentrant=False,
                           context_fn=moe_lib.checkpoint_contexts)
        else:
            x = _layer(cfg, plan, x, axes, lp, attend)
    logits, la, ha = _head(cfg, plan, params, x, axes)
    return logits, la, axes, ha


def forward(params: dict, layers: list, tokens, cfg, mesh, specs: dict) -> Tensor:
    """tokens (B, S) → logits (B, S, V), whole on every process; `params`
    laid out by `transformer.shard_params`, `layers` its per-layer leaves."""
    plan = _plan(cfg, mesh, specs, len(tokens))
    logits, _, _, vocab = _logits(cfg, plan, params, layers, tokens)
    return _whole_logits(plan, logits, vocab)


def _nll(plan: _Plan, logits: Tensor, l_axes: frozenset, labels: Tensor, vocab: frozenset) -> tuple[Tensor, frozenset]:
    """Each engine's token nll (local engines…, B_l, S) in float32."""
    mesh, n = plan.mesh, len(plan.mesh.axis_names)
    lf = logits.float()
    labels = labels.expand(*lf.shape[:-1])
    if plan.tp is None or plan.tp not in vocab:
        gold = torch.gather(lf, -1, labels[..., None])[..., 0]
        return torch.logsumexp(lf, dim=-1) - gold, l_axes
    a, rows = mesh.axis_index(plan.tp), lf.shape[-1]
    mx = mesh.all_gather(lf.detach().amax(-1, keepdim=True), plan.tp).amax(a, keepdim=True)
    logz = mx[..., 0] + torch.log(mesh.psum(torch.exp(lf - mx).sum(-1), plan.tp))
    loc = labels - _tp_offset(plan, rows, vocab, labels.device)
    ok = (loc >= 0) & (loc < rows)
    gold = torch.gather(lf, -1, loc.clamp(0, rows - 1)[..., None])[..., 0]
    gold = mesh.psum(torch.where(ok, gold, gold.new_zeros(())), plan.tp)
    return logz - gold, l_axes - {plan.tp}


def _engine_sums(t: Tensor, n: int) -> Tensor:
    """t (local engines…, …) → (local engines…): each engine's sum over its
    own block, whatever is stacked beside it."""
    return torch.stack([b.sum() for b in t.reshape(*t.shape[:n], -1).flatten(0, n - 1)]).view(t.shape[:n])


def loss_fn(params: dict, layers: list, batch: dict, cfg, mesh, specs: dict) -> Tensor:
    """The mean token cross-entropy (0-d, float32, the same on every
    process) of `batch` ({"tokens", "labels"}, optionally "valid")."""
    plan = _plan(cfg, mesh, specs, len(batch["tokens"]))
    n = len(mesh.axis_names)
    logits, la, axes, vocab = _logits(cfg, plan, params, layers, batch["tokens"])
    nll, na = _nll(plan, logits, la, _rows(plan, batch["labels"]).long(), vocab)
    valid = batch.get("valid")
    if valid is None:
        total, count = _engine_sums(nll, n), float(np.prod(np.shape(batch["labels"])))
    else:
        v = _rows(plan, valid).float().expand(*nll.shape)
        total, count = _engine_sums(nll * v, n), _engine_sums(v, n)
    for a in _ordered(mesh, na):
        total = mesh.psum(total, a)
        if valid is not None:
            count = mesh.psum(count, a)
    loss = total / (count if valid is None else torch.clamp(count, min=1.0))
    return loss.reshape(())


# ------------------------------ serving ---------------------------------------


def _cache_batch(cache: dict, cache_spec, mesh) -> tuple[tuple[str, ...], int]:
    """The KV cache's batch axes (its spec's, in the spec's order) and its
    rows: (local engines…, L, B_l, max_seq, Hkv_l, dh) holds B_l · their
    size."""
    batch = _axes(tuple(cache_spec)[1])
    return batch, cache["k"].shape[len(mesh.axis_names) + 1] * int(np.prod([mesh.shape[a] for a in batch]))


def _check_rows(plan: _Plan, batch: tuple[str, ...], b: int, rows: int, what: str) -> None:
    size = int(np.prod([plan.mesh.shape[a] for a in batch]))
    if b % size:
        raise ValueError(f"{what} of {b} rows does not divide over the rules' batch axes {batch} ({size} engines): "
                         "the KV cache's spec splits its batch over them")
    if b != rows:
        raise ValueError(f"{what} of {b} rows for a KV cache of {rows}")
    if plan.batch != batch:
        raise ValueError(f"the token rows split over {plan.batch}, the KV cache's over {batch}: lay the mesh's axes "
                         "out in the rules' order")


def _slot_block(mesh, batch: tuple[str, ...], rows_l: int, slot: int) -> tuple | None:
    """Where row `slot` of a cache split over `batch` lies (`shard_tensor`'s
    order: block slot // rows_l, its coordinates row-major over `batch`):
    (the index of its block among this process's local engines — one slice
    a local axis — , its row there), or None where no local engine holds
    it."""
    sizes = [mesh.shape[a] for a in batch]
    if not 0 <= slot < rows_l * int(np.prod(sizes)):
        raise IndexError(f"slot {slot} of a KV cache of {rows_l * int(np.prod(sizes))} rows")
    index = [slice(None)] * len(mesh.axis_names)
    for a, c in zip(batch, np.unravel_index(slot // rows_l, sizes) if batch else ()):
        local = mesh.local_coords(a).tolist()
        if int(c) not in local:
            return None
        i = local.index(int(c))
        index[mesh.axis_index(a)] = slice(i, i + 1)
    return tuple(index), slot % rows_l


def _prompt_attention(cfg, cos, sin, write, ck: Tensor, cv: Tensor, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """`_causal` over a fresh prompt whose k/v `write(block, t)` puts into
    this layer's cache blocks first; attention reads them back as the cache
    holds them (a no-op cast where the cache is q's type)."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    write(ck, k)
    write(cv, v)
    return _flash(cfg, q, k.to(ck.dtype).to(q.dtype), v.to(cv.dtype).to(q.dtype))


def _decode_attention(cos, sin, at: Tensor, valid: Tensor, ck: Tensor, cv: Tensor, q: Tensor, k: Tensor,
                      v: Tensor) -> Tensor:
    """One token a row: RoPE at the rows' positions (cos/sin (local
    engines…, B_l, 1, half)), row b's k/v written at `at[b]` into the
    engine's cache block, then `gqa_attention` once over every engine's
    block folded into its batch, row b over its first `valid[b]` positions."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    lead = q.shape[:-3]  # (local engines…, B_l): the cache blocks' too
    grids = torch.meshgrid(*(torch.arange(s, device=q.device) for s in lead), indexing="ij")
    where = (*grids, at.expand(lead))
    ck[where] = k[..., 0, :, :].to(ck.dtype)
    cv[where] = v[..., 0, :, :].to(cv.dtype)
    out = gqa_attention(_folded(q), _folded(ck), _folded(cv), causal=False,
                        kv_valid_len=valid.expand(lead).reshape(-1))
    return out.reshape(q.shape)


def _last_logits(cfg, plan: _Plan, params: dict, x: Tensor, axes: frozenset) -> Tensor:
    """(B, V) on every process: the head at each row's last position only."""
    logits, _, vocab = _head(cfg, plan, params, x[..., -1:, :], axes)
    return _whole_logits(plan, logits, vocab)[:, 0]


def prefill(params: dict, layers: list, tokens, cache: dict, cfg, mesh, specs: dict, cache_spec,
            slot: int | None = None) -> Tensor:
    """Prefill from position 0: tokens (B, S) → their last positions' logits
    (B, V), whole on every process; each engine writes its own rows' and
    heads' k/v into its block of `cache` (laid out by `cache_spec`,
    `transformer.kv_cache_specs`; where the KV heads do not divide over
    "model" it is whole along it, and the gathered k/v are what every model
    engine writes).  With `slot`, one prompt (1, S) for cache row `slot`:
    it does not divide over the batch axes, so every engine computes it
    (on "stacked" once, held once along them; on "process_group" on every
    rank of the row), and only the engines whose block holds the slot write
    it.  Attention is one `flash_attention` launch a layer over every
    engine's heads."""
    n = len(mesh.axis_names)
    tokens = torch.as_tensor(tokens, device=mesh.device)
    b, s = tokens.shape
    if s > cache["k"].shape[n + 2]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's {cache['k'].shape[n + 2]} positions")
    plan = _plan(cfg, mesh, specs, b)
    batch, rows = _cache_batch(cache, cache_spec, mesh)
    if slot is None:
        _check_rows(plan, batch, b, rows, "a prefill")

        def write(block: Tensor, t: Tensor) -> None:
            block[..., :s, :, :] = t.to(block.dtype)
    else:
        if b != 1:
            raise ValueError(f"a prefill into slot {slot} takes one prompt, not {b}")
        where = _slot_block(mesh, batch, cache["k"].shape[n + 1], int(slot))

        def write(block: Tensor, t: Tensor) -> None:
            if where is not None:
                index, row = where
                block[index][..., row:row + 1, :s, :, :] = t.to(block.dtype)

    x, axes = _embedded(cfg, plan, params, tokens)
    cos, sin = rope_table(s, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    for i, lp in enumerate(layers):
        ck, cv = cache["k"].select(n, i), cache["v"].select(n, i)
        x = _layer(cfg, plan, x, axes, lp, functools.partial(_prompt_attention, cfg, cos, sin, write, ck, cv))
    return _last_logits(cfg, plan, params, x, axes)


def decode(params: dict, layers: list, tokens, pos, cache: dict, cfg, mesh, specs: dict, cache_spec) -> Tensor:
    """One decode step, every row at its own position: tokens (B, 1), pos
    (B,) → logits (B, V), whole on every process.  The rows and their
    positions are split as the cache's batch (B must divide over the batch
    axes); each engine writes row b at pos[b] (clamped to the cache) into
    its block and attends over it with `gqa_attention`, one call a layer
    over every engine's block."""
    n = len(mesh.axis_names)
    tokens = torch.as_tensor(tokens, device=mesh.device)
    b = tokens.shape[0]
    plan = _plan(cfg, mesh, specs, b)
    batch, rows = _cache_batch(cache, cache_spec, mesh)
    _check_rows(plan, batch, b, rows, "a decode batch")
    max_seq = cache["k"].shape[n + 2]
    pos = _rows(plan, torch.as_tensor(pos, device=mesh.device).long().reshape(b, 1))  # (local engines…, B_l, 1)
    at = pos.clamp(0, max_seq - 1)
    x, axes = _embedded(cfg, plan, params, tokens)
    cos_t, sin_t = rope_table(max_seq, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    attend = functools.partial(_decode_attention, cos_t[at], sin_t[at], at[..., 0], pos[..., 0] + 1)
    for i, lp in enumerate(layers):
        x = _layer(cfg, plan, x, axes, lp, functools.partial(attend, cache["k"].select(n, i), cache["v"].select(n, i)))
    return _last_logits(cfg, plan, params, x, axes)
