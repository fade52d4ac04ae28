"""The port's op counter: the hooks that the kernels and the mesh's
collectives count themselves through, and the shape-only formulas they
count with.  `launch.roofline` turns a counter's totals into roofline terms
against a device's peaks; this module knows no device.

`CostCounter`, a `TorchDispatchMode`, counts the aten ops the port issues
while it runs a step (the port's counterpart of XLA's
`compiled.cost_analysis()`):
  * FLOPs by `torch.utils.flop_counter`'s formula registry (matrix products,
    convolutions, attention), kept apart by the dtype of the op's first
    tensor, since bf16 runs on the tensor cores and float32 on the CUDA cores
    (TF32 is off by default);
  * bytes as each op's tensor inputs read once and its outputs written once.
    Eager PyTorch does not fuse, so that is the traffic the port really
    issues; an op whose inputs the L2 serves counts them all the same.  View
    ops (`view`, `reshape` of a contiguous tensor, `transpose`, `expand`,
    `select`, `slice`, `as_strided`, …), factories that write nothing
    (`empty*`) and host reads of a scalar count nothing; `copy_` reads its
    source only;
  * the hand-written kernels count themselves, once, at their entry
    (`kernels/*/ops.py` call `kernel_cost`): their FLOPs and bytes follow
    from the shapes alone (`attention_flops`, `attention_fwd_bytes`,
    `attention_bwd_bytes`, `ell_reduce_cost`, `bag_cost`), so a `meta` run
    and the card agree, and the route that runs inside — the `ctypes`
    kernel, which the dispatcher cannot see, or the plain version — is not
    counted again;
  * the collectives count themselves too (`graph.distributed.EngineMesh`
    calls `count_collective`): each adds its per-engine output bytes times
    the reference's ring factor, under the reference's op kinds.
A run on `device="meta"` counts the same as one on the card or the CPU: no
memory is allocated and no kernel launches.  Where no counter is active a
hook returns at once and computes nothing.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["CostCounter", "active_counter", "kernel_cost", "count_collective", "attention_flops",
           "attention_fwd_bytes", "attention_bwd_bytes", "ell_reduce_cost", "bag_cost"]

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)


def _ring_factor(op: str, g: int) -> float:
    """Per-device link bytes ≈ factor × output bytes (ring algorithms):
    all-gather: (g−1)/g·g·shard = output          → ×1
    all-reduce: 2·(g−1)/g·output                  → ×2·(g−1)/g
    reduce-scatter: (g−1)·output (output = 1/g)   → ×(g−1)
    all-to-all / collective-permute: ≈ output     → ×1
    """
    if op == "all-reduce":
        return 2.0 * (g - 1) / max(g, 1)
    if op == "reduce-scatter":
        return float(max(g - 1, 1))
    return 1.0


_ACTIVE: list = []  # the counters entered, innermost last (seen from autograd's threads too)
_aten = torch.ops.aten
_NO_BYTES = {  # ops that move no data: views the schema does not mark, factories that write nothing, host reads
    _aten._unsafe_view, _aten.alias, _aten.lift_fresh, _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size, _aten.detach,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs (by dtype), the bytes and the collectives' link bytes
    of what runs inside `with CostCounter() as c:` — every engine of a
    "stacked" mesh, or this rank's engine on "process_group".  Counts are
    totals of the run: `flops_by_dtype` ({dtype name: FLOPs}), `flops`,
    `bytes`, `coll` ({op kind: link bytes of one engine}), `coll_calls`
    [(kind, group size, per-engine output bytes)], and `kernels` ({entry:
    calls counted at its entry}).  The same on `cuda`, `cpu` and `meta`
    tensors."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops_by_dtype: dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.coll: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.coll_calls: list[tuple[str, int, float]] = []
        self.kernels: dict[str, int] = defaultdict(int)
        self._paused = 0

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype[k] for k in sorted(self.flops_by_dtype)))

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll[k] for k in _COLLECTIVES))

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Nothing inside is counted (a kernel entry's own route)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count_op(func, args, kwargs, out)
        return out

    def _count_op(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        inputs = _tensors((args, kwargs))
        formula = self._formulas.get(packet)
        if formula is not None and inputs:
            self.flops_by_dtype[str(inputs[0].dtype).removeprefix("torch.")] += float(
                formula(*args, **kwargs, out_val=out))
        if func.is_view or packet in _NO_BYTES:
            return
        if packet is _aten.copy_:  # the destination is written, not read
            self.bytes += _nbytes(args[1]) + _nbytes(args[0])
            return
        self.bytes += sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in _tensors(out))

    def add_kernel(self, name: str, flops: float, dtype: torch.dtype, nbytes: float) -> None:
        self.flops_by_dtype[str(dtype).removeprefix("torch.")] += float(flops)
        self.bytes += float(nbytes)
        self.kernels[name] += 1

    def add_collective(self, kind: str, out_bytes: float, group: int) -> None:
        self.coll[kind] += float(out_bytes) * _ring_factor(kind, group)
        self.coll_calls.append((kind, int(group), float(out_bytes)))

    def totals(self) -> dict:
        """The counts as plain numbers (JSON-ready)."""
        return {"flops_by_dtype": dict(self.flops_by_dtype), "flops": self.flops, "bytes": self.bytes,
                "coll": {k: v for k, v in self.coll.items() if v}, "coll_bytes": self.coll_bytes,
                "kernels": dict(self.kernels)}


def active_counter() -> CostCounter | None:
    """The innermost `CostCounter` entered, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel_cost(name: str, cost):
    """A kernel entry's own count: where a counter is active, `cost()` =
    (FLOPs, dtype, bytes), read from the shapes only, is added once, and
    nothing inside the block (the kernel's route) is counted again."""
    c = active_counter()
    if c is None or c._paused:
        yield
        return
    flops, dtype, nbytes = cost()
    c.add_kernel(name, flops, dtype, nbytes)
    with c.paused():
        yield


def count_collective(kind: str, cost) -> None:
    """One collective of `kind`, added to the active counter: `cost()` =
    (per-engine output bytes, group size), called only where a counter is
    active."""
    c = active_counter()
    if c is not None and not c._paused:
        c.add_collective(kind, *cost())


# ------------------------- the kernels' work, from shapes ------------------------


def _kept_prefix(m: int, skv: int) -> int:
    """Σ_{j=1..m} min(skv, max(0, j))."""
    if m <= 0:
        return 0
    if m <= skv:
        return m * (m + 1) // 2
    return skv * (skv + 1) // 2 + (m - skv) * skv


def attention_flops(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int) -> float:
    """The multiply-adds (×2) of QKᵀ and P·V on the score pairs the mask keeps."""
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    if causal:  # query row i keeps keys 0 .. i + q_offset
        pairs = _kept_prefix(sq + q_offset, skv) - _kept_prefix(q_offset, skv)
    else:
        pairs = sq * skv
    return 4.0 * b * hq * dh * pairs


def attention_fwd_bytes(q: torch.Tensor, k: torch.Tensor, with_lse: bool = False) -> int:
    """q, k, v read once and the output (and the log-sum-exp) written once."""
    return (2 * q.numel() + 2 * k.numel()) * q.element_size() + (q.numel() // q.shape[-1] * 4 if with_lse else 0)


def attention_bwd_bytes(q: torch.Tensor, k: torch.Tensor) -> int:
    """q, k, v, o, dO and lse read once and dQ, dK, dV written once."""
    return (4 * q.numel() + 4 * k.numel()) * q.element_size() + q.numel() // q.shape[-1] * 4


def ell_reduce_cost(x: torch.Tensor, ell) -> tuple[float, int]:
    """(FLOPs, bytes) of one whole reduce over `ell`, from its shapes: a
    multiply-add an ELL slot (padding included) and feature; the cols (and
    weights) and the bucket rows read once, each slot's row of x gathered
    once, the (N, D) output written once."""
    slots = sum(int(c.numel()) for c in ell.cols)
    rows = sum(int(r.numel()) for r in ell.rows)
    d, item = x.shape[1], x.element_size()
    nbytes = slots * 4 * (2 if ell.weights is not None else 1) + rows * 4 + slots * d * item + x.shape[0] * d * item
    return 2.0 * slots * d, nbytes


def bag_cost(tables: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None) -> tuple[float, int]:
    """(FLOPs, bytes) of one `embedding_bag` call, from its shapes: a
    multiply-add a slot and feature; the ids (and weights) read once, each
    slot's table row gathered once, the (B, T, D) output written once."""
    _, _, d = tables.shape
    b, t, l = ids.shape
    item = tables.element_size()
    nbytes = ids.numel() * ids.element_size() + (weights.numel() * weights.element_size() if weights is not None
                                                  else 0)
    nbytes += b * t * l * d * item + b * t * d * item
    return 2.0 * b * t * l * d, nbytes
