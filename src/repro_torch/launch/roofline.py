"""Roofline terms of the port, counted from its own ops (the port of
`repro.launch.roofline`).

  compute term    = Σ_dtype FLOPs_dtype / peak_dtype      (per device)
  memory term     = bytes / memory rate                    (per device)
  collective term = collective link bytes / link rate      (per device)

The reference reads FLOPs and bytes from XLA's `compiled.cost_analysis()`
and parses the collectives out of the optimized HLO text.  Eager PyTorch has
no compiled program to ask, so `obs.cost.CostCounter`, a
`TorchDispatchMode`, counts the aten ops the port issues while it runs a
step, the hand-written kernels at their entries and the mesh's collectives
(see `repro_torch.obs.cost`); this module sets its totals against one
device's peaks (`HW`, `Roofline`).  The counter, the reference's op kinds
(`_COLLECTIVES`) and ring factors (`_ring_factor`) live in `obs.cost`, which
the kernels and the mesh import; they are named here too.

The kernels' bounds that `chip_smoke.py` prints (`*_bound_ms`: the bytes a
call must move and the work it must do on this call's data) and the byte
counters of the mesh paths' collectives (`dense_step_bytes`,
`dense_serve_bytes`, `moe_tp_bytes`) live here too, so that a benchmark reads
the same work whatever code implements it.

Hardware constants: one NVIDIA H100 80GB HBM3 at its 700 W power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
"NVIDIA H100 80GB HBM3, 700.00 W"), from the H100 SXM data sheet.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch.obs.cost import (  # noqa: F401  (_COLLECTIVES, _ring_factor: the reference's names)
    _COLLECTIVES,
    CostCounter,
    _ring_factor,
    attention_bwd_bytes,
    attention_flops,
    attention_fwd_bytes,
)

__all__ = ["HW", "H100", "Roofline", "attention_flops", "attention_bound_ms", "attention_bwd_bound_ms",
           "bucket_bound_ms", "reduce_bound_ms", "gin_reduce_bound_ms", "bag_bound_ms", "gather_bytes",
           "dense_step_bytes", "dense_serve_bytes", "moe_tp_bytes", "moe_decode_bytes", "grad_reduce_bytes",
           "received_bytes", "H100_BYTES_PER_S", "H100_F32_FLOPS", "H100_BF16_FLOPS", "SECTOR_BYTES"]


@dataclasses.dataclass(frozen=True)
class HW:
    """Peaks of one device.  The field names are the reference's
    (`peak_flops` the bf16 rate a device, `hbm_bw` its memory rate, `ici_bw`
    the link rate the collective term divides by); `f32_flops` is the rate
    of float32 outside the tensor cores."""

    peak_flops: float = 989e12  # dense bf16 on the tensor cores: NVIDIA H100 80GB HBM3, 700 W
    hbm_bw: float = 3.35e12  # HBM3 bytes/s: NVIDIA H100 80GB HBM3, 700 W
    ici_bw: float = 450e9  # NVLink 4, bytes/s one direction a GPU: NVIDIA H100 80GB HBM3, 700 W
    f32_flops: float = 67e12  # float32 on the CUDA cores: NVIDIA H100 80GB HBM3, 700 W

    def peak_for(self, dtype: str) -> float:
        """The peak that FLOPs of `dtype` (a `torch.dtype`'s name) run at."""
        return self.peak_flops if dtype in ("bfloat16", "float16") else self.f32_flops


H100 = HW()
H100_BYTES_PER_S = H100.hbm_bw
H100_F32_FLOPS = H100.f32_flops
H100_BF16_FLOPS = H100.peak_flops
SECTOR_BYTES = 32  # the unit in which device memory serves a gathered row

@dataclasses.dataclass
class Roofline:
    """All hlo_*/coll_* quantities are PER DEVICE: the counted totals of a
    run over every engine of the mesh, divided by the engine count (the
    collectives' link bytes are one engine's already).  model_flops is
    GLOBAL useful FLOPs — the ideal time divides it by the chip count.
    `flops_by_dtype` (per device) splits hlo_flops by the dtype its ops ran
    in; each part runs at its own peak.  Without it every FLOP runs at the
    bf16 peak, as the reference costs them."""

    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict[str, float]
    model_flops: float
    bytes_per_device: float | None = None
    hw: HW = dataclasses.field(default_factory=HW)
    flops_by_dtype: dict[str, float] | None = None
    device: str = "meta"
    counted_by: str = "repro_torch.obs.cost.CostCounter"
    measured: dict | None = None

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.hlo_flops / self.hw.peak_flops
        return sum(f / self.hw.peak_for(d) for d, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        global_hlo = self.hlo_flops * self.chips
        return self.model_flops / global_hlo if global_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """fraction of peak the dominant-term-bound step achieves on useful
        FLOPs:   (model_flops / chips / peak) / max(term)."""
        t_ideal = self.model_flops / (self.chips * self.hw.peak_flops)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_ideal / t_bound if t_bound else 0.0

    def to_dict(self) -> dict:
        out = {
            "arch": self.arch,
            "cell": self.cell,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_device": self.bytes_per_device,
            "flops_by_dtype": self.flops_by_dtype,
            "device": self.device,
            "counted_by": self.counted_by,
            "hw": dataclasses.asdict(self.hw),
        }
        if self.measured is not None:
            out["measured"] = self.measured
        return out


# ------------------------------- the counter's totals --------------------------------


def received_bytes(counter: CostCounter, engines: int) -> dict[str, float]:
    """The counter's collectives as the bytes all `engines` receive, each run
    as the port runs it on "process_group" (an engine of a group of g
    receives g − 1 blocks: of its output for an all-reduce, a gather of the
    blocks then a fold; (g − 1)/g of its output for an all-gather), the
    all-to-alls whole (their output), by op kind: the unit of
    `dense_step_bytes`, `dense_serve_bytes` and `moe_tp_bytes`."""
    share = {"all-reduce": lambda g: g - 1, "all-gather": lambda g: (g - 1) / g}
    out: dict[str, float] = defaultdict(float)
    for kind, g, nbytes in counter.coll_calls:
        out[kind] += engines * nbytes * share.get(kind, lambda g: 1)(g)
    return dict(out)


# ------------------------- the kernels' bounds ------------------------


def _peak(dtype: torch.dtype) -> float:
    return H100.peak_for(str(dtype).removeprefix("torch."))


def attention_bound_ms(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> tuple[float, str]:
    """Least time for one `flash_attention` call on these inputs: q, k, v read
    once and the output written once over the memory rate, against
    `attention_flops` over the tensor-core (bf16) or CUDA-core (f32) rate."""
    t_ops = attention_flops(q, k, causal, q_offset) / _peak(q.dtype)
    t_bytes = attention_fwd_bytes(q, k) / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_bound_ms(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> tuple[float, str]:
    """Least time for one backward on these inputs: five products a kept
    pair where the forward does two (2.5x `attention_flops`) over the
    tensor-core or CUDA-core rate, against q, k, v, o, dO and lse read once
    and dQ, dK, dV written once over the memory rate."""
    t_ops = 2.5 * attention_flops(q, k, causal, q_offset) / _peak(q.dtype)
    t_bytes = attention_bwd_bytes(q, k) / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")



def bucket_bound_ms(x: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor | None) -> tuple[float, str]:
    """Least time for one `ell_spmm` call on these inputs: bytes (cols and wts
    read once, each gathered x row once, the output written once) over the
    memory rate, against multiply-adds on the real entries over the f32 rate."""
    n, d = x.shape
    real = cols[(cols >= 0) & (cols < n)]
    touched = int(torch.unique(real).numel())
    item = x.element_size()
    nbytes = cols.numel() * 4 + (wts.numel() * 4 if wts is not None else 0)
    nbytes += touched * d * item + cols.shape[0] * d * item
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * real.numel() * d / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def reduce_bound_ms(x: torch.Tensor, ell) -> tuple[float, str]:
    """Least time for one whole `segment_spmm` reduce on these inputs: the flat
    cols, weights and rows, the work table and the zero list read once, each
    gathered x row once, the (N, D) output written once, over the memory rate,
    against multiply-adds on the real entries over the f32 rate."""
    n, d = x.shape
    work = ell.work()
    real = work.cols[(work.cols >= 0) & (work.cols < n)]
    item = x.element_size()
    nbytes = (work.cols.numel() + work.rows.numel() + work.zero_rows.numel()) * 4 + work.items.numel() * 8
    nbytes += (work.weights.numel() * 4 if work.weights is not None else 0)
    nbytes += int(torch.unique(real).numel()) * d * item + n * d * item
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * real.numel() * d / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gin_reduce_bound_ms(x: torch.Tensor, ell) -> float:
    """Least time for one GIN neighbour sum on these inputs: the rows of x that
    some edge reads, the real cols (one int32 an edge) and the (N, D) output,
    each once, over the memory rate (it is bound by bytes: one multiply-add
    an edge and feature)."""
    n, d = x.shape
    cols = ell.work().cols
    real = cols[(cols >= 0) & (cols < n)]
    nbytes = int(torch.unique(real).numel()) * d * 4 + real.numel() * 4 + n * d * 4
    return nbytes / H100_BYTES_PER_S * 1e3



def bag_bound_ms(tables: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None) -> tuple[float, str, int]:
    """Least time for one `embedding_bag` call on these inputs: the ids (and
    weights) read once, each distinct (t, id) row once in whole 32-byte
    sectors, and the output written once, over the memory rate — hot Zipf
    rows come again and again, and a bound that counted every gathered row
    would be beaten by the L2 — against the multiply-adds of the real slots
    over the f32 rate.  Returns (ms, what bounds it, distinct rows)."""
    t, v, d = tables.shape
    b = ids.shape[0]
    valid = (ids >= 0) & (ids < v)
    rows = (torch.arange(t, device=ids.device)[None, :, None] * v + ids.long())[valid]
    distinct = int(torch.unique(rows).numel())
    item = tables.element_size()
    row_bytes = -(-d * item // SECTOR_BYTES) * SECTOR_BYTES
    nbytes = distinct * row_bytes + ids.numel() * 4 + (weights.numel() * 4 if weights is not None else 0)
    nbytes += b * t * d * item
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * int(valid.sum()) * d / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), distinct


# ------------------------- the mesh paths' collective bytes ---------------------


def gather_bytes(mesh, fsdp: set, shape: tuple, spec, itemsize: int) -> int:
    """Bytes all engines receive in one FSDP gather of a leaf of `shape`
    laid out by `spec`: over the `fsdp` axes its dims are split over (an
    engine of a group of g receives g - 1 blocks)."""
    axes = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
    group = int(np.prod([mesh.shape[a] for a in axes if a in fsdp]))
    split = int(np.prod([mesh.shape[a] for a in axes]))
    return mesh.num_engines * (group - 1) * int(np.prod(shape)) * itemsize // split


def _batch_axes(cfg, mesh) -> list[str]:
    return [a for a in cfg.rules.batch if a in mesh.shape]


def grad_reduce_bytes(cfg, mesh, leaves) -> int:
    """Bytes all engines receive in the reductions of the gradients of
    `leaves` [(whole shape, spec)] (float32) as the port runs them: each
    engine's gradient of the leaf, gathered over its fsdp axes (whole there,
    its block along the axes it still differs along), summed over every
    batch axis it does not differ along, one `psum` an axis (an engine of a
    group of g receives g − 1 copies); its own block is then kept."""
    fsdp = set(_axes_of(cfg.rules.fsdp))
    total = 0
    for shape, spec in leaves:
        varying = [a for e in tuple(spec) for a in _axes_of(e) if a not in fsdp and a in mesh.shape]
        per_engine = int(np.prod(shape)) * 4 // int(np.prod([mesh.shape[a] for a in varying]))
        total += mesh.num_engines * sum(mesh.shape[a] - 1 for a in _batch_axes(cfg, mesh) if a not in varying) \
            * per_engine
    return total


def _axes_of(entry) -> tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _lm_leaves(cfg, specs) -> list:
    """[(whole shape, spec)] of every leaf of the transformer's params."""
    from repro_torch.models import transformer as tfm

    out = [((cfg.n_layers, *shape), specs["layers"][k]) for k, shape in tfm.layer_shapes(cfg).items()]
    out += [((cfg.vocab, cfg.d_model), specs["embed"]), ((cfg.d_model,), specs["final_norm"])]
    if not cfg.tie_embeddings:
        out.append(((cfg.d_model, cfg.vocab), specs["lm_head"]))
    return out


def dense_step_bytes(cfg, mesh, batch: int, seq: int) -> dict:
    """The bytes one training step's collectives move on `mesh` under
    `cfg.rules`, each as the port runs it (an all-gather-based collective: an
    engine receives its group's other blocks), summed over the engines:
    the FSDP gathers of the float32 weights (each layer's twice, forward and
    recompute; the embedding's and lm_head's once), the reductions of their
    gradients (`grad_reduce_bytes`: a psum of each engine's gathered
    gradient over every batch axis it does not differ along, the norms'
    too), the model-axis psums of the row-parallel partials (the attention's
    twice a layer, forward and recompute, the FFN's once: the recompute stops
    before it, as the non-reentrant checkpoint does once every saved tensor
    is back) and the folds of Megatron's f in the backward (the attention's
    and the FFN's inputs, lm_head's), in `cfg.dtype`, the embedding's
    float32 psum, the vocab-parallel cross-entropy's three (max, sum of
    exponentials, gold logit) and the loss's sums over the batch axes."""
    from repro_torch.models import transformer as tfm

    r, specs, engines = cfg.rules, tfm.param_specs(cfg, mesh), mesh.num_engines
    fsdp = set(_axes_of(r.fsdp))

    def gathered(shape, spec) -> int:  # a float32 leaf
        return gather_bytes(mesh, fsdp, shape, spec, 4)

    layer = sum(gathered(shape, specs["layers"][k][1:]) for k, shape in tfm.layer_shapes(cfg).items())
    top = gathered((cfg.vocab, cfg.d_model), specs["embed"])
    top += 0 if cfg.tie_embeddings else gathered((cfg.d_model, cfg.vocab), specs["lm_head"])
    tp = mesh.shape[r.model] if r.model in mesh.shape else 1
    rows = batch * seq // int(np.prod([mesh.shape[a] for a in _batch_axes(cfg, mesh)]))  # an engine's tokens
    act = engines * (tp - 1) * rows * cfg.d_model  # one model-axis psum of (rows, d), in elements
    item = torch.finfo(cfg.dtype).bits // 8
    vocab_split = tuple(specs["embed"])[0] is not None
    loss_axes = [a for a in _batch_axes(cfg, mesh) if a != r.model]
    return {"fsdp_gathers": cfg.n_layers * 2 * layer + top,
            "grad_reductions": grad_reduce_bytes(cfg, mesh, _lm_leaves(cfg, specs)),
            "model_psums": (cfg.n_layers * (3 + 2) + 1) * act * item if tp > 1 else 0,
            "embedding_psum": act * 4 if vocab_split else 0,
            "cross_entropy": engines * (tp - 1) * rows * 3 * 4 if vocab_split else 0,
            "loss_sums": engines * sum(mesh.shape[a] - 1 for a in loss_axes) * 4,
            "counted": "bytes all engines receive; an engine of a group of g receives g - 1 blocks"}


def dense_serve_bytes(cfg, mesh, rows: int, seq: int, batch_split: bool) -> dict:
    """The bytes one forward of a served dense model (a prefill of `rows` ×
    `seq` tokens, or a decode step of `rows` × 1) moves on `mesh` under
    `cfg.rules`, each collective as the port runs it on a real mesh (an
    all-gather-based collective: an engine receives its group's other
    blocks), summed over the engines: the FSDP gathers of every weight in
    `cfg.dtype` (once a forward), the model-axis psums of the row-parallel
    partials (two a layer) and of the vocab-parallel embedding, in
    `cfg.dtype`, and the gather of the last position's logits (over the
    vocab's axes, and the batch's where `batch_split`: the rows split over
    them, else every engine holds them all)."""
    from repro_torch.models import transformer as tfm

    r, specs, engines = cfg.rules, tfm.param_specs(cfg, mesh), mesh.num_engines
    fsdp = set((r.fsdp,) if isinstance(r.fsdp, str) else r.fsdp)
    item = torch.finfo(cfg.dtype).bits // 8

    def gathered(shape, spec) -> int:
        return gather_bytes(mesh, fsdp, shape, spec, item)

    layer = sum(gathered(shape, specs["layers"][k][1:]) for k, shape in tfm.layer_shapes(cfg).items())
    top = gathered((cfg.vocab, cfg.d_model), specs["embed"])
    top += 0 if cfg.tie_embeddings else gathered((cfg.d_model, cfg.vocab), specs["lm_head"])
    tp = mesh.shape[r.model] if r.model in mesh.shape else 1
    b_size = int(np.prod([mesh.shape[a] for a in r.batch if a in mesh.shape])) if batch_split else 1
    local_rows = rows // b_size
    act = engines * (tp - 1) * local_rows * seq * cfg.d_model * item  # one model-axis psum
    vocab_split = tuple(specs["embed"])[0] is not None
    vocab_l = cfg.vocab // (tp if tuple(specs["lm_head"])[1] is not None else 1)
    logits = engines * (b_size - 1) * local_rows * vocab_l + engines * (tp - 1) * rows * vocab_l
    return {"fsdp_gathers": cfg.n_layers * layer + top, "model_psums": 2 * cfg.n_layers * act,
            "embedding_psum": act if vocab_split else 0, "logits_gather": logits * item,
            "counted": "bytes all engines receive; an engine of a group of g receives g - 1 blocks"}


def moe_tp_bytes(cfg, mesh, rows: int, seq: int, batch_split: bool) -> dict:
    """The bytes one forward of an MoE model served under tp_sp with EP (a
    prefill of `rows` × `seq` tokens, or a decode step of `rows` × 1) moves
    on `mesh`, from the specs, each collective as the port runs it (an
    all-gather-based collective: an engine receives its group's other
    blocks), summed over the engines: the router's "data" gather (float32)
    and the other FSDP gathers (attention, norms, shared expert, embedding,
    lm_head, in `cfg.dtype`), the "model" psums (wo's, the shared expert's
    ws_down, the embedding's), EP's all-to-alls (tokens there and outputs
    back in `cfg.dtype`, and the expert ids, over the whole capacity-sized
    buffers), EP's gathers (the rows over "data" where the blocks do not
    coincide, every engine's output back), the last positions' logits."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm

    m, specs, engines = cfg.moe, tfm.param_specs(cfg, mesh), mesh.num_engines
    item, d = torch.finfo(cfg.dtype).bits // 8, cfg.d_model
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    b_size = dp if batch_split else 1
    b_l = rows // b_size
    shapes = {k: s for k, s in tfm.layer_shapes(cfg).items() if k not in moe_lib.EXPERT_KEYS}
    router = gather_bytes(mesh, {"data"}, shapes.pop("router"), specs["layers"]["router"][1:], 4)
    layer = sum(gather_bytes(mesh, {"data"}, s, specs["layers"][k][1:], item) for k, s in shapes.items())
    top = gather_bytes(mesh, {"data"}, (cfg.vocab, d), specs["embed"], item)
    top += 0 if cfg.tie_embeddings else gather_bytes(mesh, {"data"}, (d, cfg.vocab), specs["lm_head"], item)
    act = engines * (tp - 1) * b_l * seq * d * item  # one model-axis psum of the residual
    coincide = batch_split and (b_l * seq) % tp == 0
    n_l = -(-rows * seq // engines)
    e_l = m.padded_experts(tp) // tp
    cs, _ = moe_lib.ep_capacities(m, n_l, tp, e_l)
    a2a = 2 * engines * tp * cs * d * item + engines * tp * cs * 8
    if coincide:
        gathers = engines * (tp - 1) * n_l * d * item
    else:
        gathers = engines * (engines - 1) * n_l * d * item + engines * (b_size - 1) * b_l * seq * d * item
    vocab_l = cfg.vocab // (tp if tuple(specs["lm_head"])[1] is not None else 1)
    logits = engines * (b_size - 1) * b_l * vocab_l + engines * (tp - 1) * rows * vocab_l
    psums = (2 if m.d_ff_shared else 1) * act
    return {"router_data_gathers": cfg.n_layers * router, "other_fsdp_gathers": cfg.n_layers * layer + top,
            "model_psums": cfg.n_layers * psums, "embedding_psum": act if tuple(specs["embed"])[0] else 0,
            "ep_all_to_alls": cfg.n_layers * a2a, "ep_gathers": cfg.n_layers * gathers,
            "logits_gather": logits * item, "ep_tokens_an_engine": n_l, "Cs": cs,
            "blocks_coincide": coincide,
            "counted": "bytes all engines receive; an engine of a group of g receives g - 1 blocks; the "
                       "all-to-alls whole (2·engines·model·Cs·d·itemsize and the ids)"}


def moe_decode_bytes(cfg, experts_hit: float, pos: np.ndarray) -> dict:
    """Bytes one decode step of `len(pos)` slots must move (bf16 weights, the
    float32 router, cache rows read up to each slot's position and written
    at it, logits out) over the memory rate: with every expert's weights
    read, as the dense (E, C, D) product does, and with only the
    `experts_hit` experts (summed over layers) that got a slot."""
    m, d, L, dh = cfg.moe, cfg.d_model, cfg.n_layers, cfg.head_dim
    b = len(pos)
    expert = 3 * d * m.d_ff_expert * 2
    other = L * (d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * d) * 2  # attention weights
    other += L * (3 * d * m.d_ff_shared + (d if m.d_ff_shared else 0)) * 2  # shared expert and its gate
    other += L * d * m.num_experts * 4 + (2 * L + 1) * d * 2 + d * cfg.vocab * 2  # router, norms, head
    other += b * d * 2 + b * cfg.vocab * 2  # embedding rows in, logits out
    other += 2 * L * cfg.n_kv_heads * dh * 4 * (int((pos + 1).sum()) + b)  # float32 cache: read, write
    dense, hit = L * m.num_experts * expert, experts_hit * expert
    return {"expert_bytes_dense": dense, "expert_bytes_hit": hit, "other_bytes": other,
            "bound_ms_dense": (dense + other) / H100_BYTES_PER_S * 1e3,
            "bound_ms_hit_only": (hit + other) / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}
