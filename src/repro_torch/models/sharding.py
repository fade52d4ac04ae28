"""Sharding rules: one place that decides how every tensor lands on an engine mesh.

The port of `repro.models.sharding`.  Mesh axes: ("data", "model") on one
pod, ("pod", "data", "model") across pods (`launch/mesh.py`):
  * batch      → ("pod", "data")          (DP across pods and the data axis)
  * params     → FSDP on "data" for one non-model dim + TP on "model"
                 (Megatron column/row parallel; vocab sharded on "model")
  * experts    → "model" (expert parallelism, `models.moe`, impl="ep_shardmap")

What carries over: the spec `P` (a tuple of axis names, None, or tuples of
names, as `jax.sharding.PartitionSpec`), `axis_if_divisible` (a dim that does
not divide over its axes is replicated, not padded) and `MeshRules` with its
parameter specs, for both strategies and `multi_pod`, equal to the
reference's.

What changes: eager PyTorch has no GSPMD and no ambient mesh.  The mesh is an
explicit argument (`graph.distributed.EngineMesh`, the caller's), and a
tensor is laid out on it by `shard_tensor` and put back whole by
`unshard_tensor`, where the reference leaves that to `jax.jit`; inside a
per-engine body `gather_dim` reassembles a dim split over some axes and
`own_block` cuts one out, each with its transpose.  So
`constrain`, the activation helpers (`act_*`), `active_mesh` and
`compat_shard_map` are not ported: a model path that runs on a mesh takes it
as `mesh=` and runs its per-engine body over the mesh's local-engine axes.
`axis_if_divisible` without a mesh returns the axis, as the reference's does
outside a mesh context.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["P", "MeshRules", "axis_if_divisible", "laid_out_shape", "shard_tensor", "unshard_tensor", "gather_dim",
           "own_block"]


class P(tuple):
    """A partition spec: entry i names the mesh axis (or a tuple of axes, in
    row-major order) that tensor dim i is split over, None where it is whole;
    dims past the spec's length are whole.  A one-axis tuple is kept as its
    axis, as `jax.sharding.PartitionSpec` keeps it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))


def axis_if_divisible(dim: int, axis: str | tuple[str, ...] | None, mesh=None):
    """`axis` if `dim` divides evenly over it on `mesh` (None: no mesh, the axis
    as given); None where the mesh lacks one of its axes or it does not divide."""
    if axis is None:
        return None
    if mesh is None:
        return axis
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    size = 1
    for a in axes:
        if a not in mesh.shape:
            return None
        size *= mesh.shape[a]
    return axis if dim % size == 0 else None


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Canonical axis assignments; `multi_pod` only adds "pod" to batch.

    strategy:
      "tp_sp" — Megatron tensor parallel on "model" + sequence parallelism
                (the memory-safe default for wide models and the EP home
                for MoE experts).
      "fsdp"  — ZeRO-3: parameters sharded over the flattened
                ("data","model") axes, batch over everything, no TP
                collectives.
    """

    multi_pod: bool = False
    strategy: str = "tp_sp"

    @property
    def batch(self) -> tuple[str, ...]:
        if self.strategy == "fsdp":
            return ("pod", "data", "model") if self.multi_pod else ("data", "model")
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def fsdp(self):
        return ("data", "model") if self.strategy == "fsdp" else "data"

    @property
    def model(self):
        return None if self.strategy == "fsdp" else "model"

    # --- parameter specs (leading `prefix` dims, e.g. the stacked layer dim) ---
    def col_parallel(self, d_in: int, d_out: int, *, prefix: int = 0, mesh=None) -> P:
        """y = x @ W, W (d_in, d_out): shard d_out on model, d_in FSDP."""
        return P(*([None] * prefix), axis_if_divisible(d_in, self.fsdp, mesh),
                 axis_if_divisible(d_out, self.model, mesh))

    def row_parallel(self, d_in: int, d_out: int, *, prefix: int = 0, mesh=None) -> P:
        """W (d_in, d_out): shard d_in on model (contracted), d_out FSDP."""
        return P(*([None] * prefix), axis_if_divisible(d_in, self.model, mesh),
                 axis_if_divisible(d_out, self.fsdp, mesh))

    def vocab_embed(self, vocab: int, d_model: int, *, mesh=None) -> P:
        return P(axis_if_divisible(vocab, self.model, mesh), axis_if_divisible(d_model, self.fsdp, mesh))

    def replicated(self, *, prefix: int = 0) -> P:
        return P(*([None] * prefix)) if prefix else P()

    def expert_weight(self, n_exp: int, d_in: int, d_out: int, *, prefix: int = 0, mesh=None) -> P:
        """(E, d_in, d_out) expert stacks: experts on model, d_in FSDP."""
        return P(*([None] * prefix), axis_if_divisible(n_exp, self.model, mesh),
                 axis_if_divisible(d_in, self.fsdp, mesh), None)


# ------------------------- laying a whole tensor out --------------------------


def _dims(x: torch.Tensor, spec, mesh) -> list[tuple[str, ...]]:
    """The mesh axes each dim of `x` is split over (empty: whole)."""
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a tensor of {x.dim()} dims")
    out, seen = [], set()
    for i, s in enumerate(spec + (None,) * (x.dim() - len(spec))):
        axes = () if s is None else ((s,) if isinstance(s, str) else tuple(s))
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names {a!r}; the mesh has {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"spec {spec} names {a!r} twice")
            seen.add(a)
        size = int(np.prod([mesh.shape[a] for a in axes]))
        if x.shape[i] % size:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide over {axes} ({size})")
        out.append(axes)
    return out


def _stacked_layout(x: torch.Tensor, dims: list, mesh) -> torch.Tensor:
    """x split as `dims` says, its mesh-axis pieces moved in front in the
    mesh's axis order (size 1 for an axis that no dim uses)."""
    shape, where = [], {}
    for i, axes in enumerate(dims):
        for a in axes:
            where[a] = len(shape)
            shape.append(mesh.shape[a])
        shape.append(x.shape[i] // int(np.prod([mesh.shape[a] for a in axes])))
    y = x.reshape(shape)
    front = [where[a] for a in mesh.axis_names if a in where]
    rest = [d for d in range(len(shape)) if d not in front]
    y = y.permute(*front, *rest)
    lead = [mesh.shape[a] if a in where else 1 for a in mesh.axis_names]
    return y.reshape(*lead, *y.shape[len(front):])


def laid_out_shape(shape: tuple[int, ...], spec, mesh) -> tuple[int, ...]:
    """The shape `shard_tensor` gives a tensor of `shape` (each split dim
    dividing over its axes): (local engines…, local block…)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    axes = [() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in entries]
    used = {a for ax in axes for a in ax}
    lead = tuple(s if a in used else 1 for a, s in zip(mesh.axis_names, mesh.local_shape))
    return lead + tuple(d // int(np.prod([mesh.shape[a] for a in ax])) for d, ax in zip(shape, axes))


def shard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor `x` laid out on `mesh` as `spec` says: (local engines…,
    local block…), each local-engine axis of the size the spec splits over it
    and 1 where the tensor is replicated along it.  On "stacked" every
    engine's block (one contiguous copy: e.g. a row-sharded (T, V, D) table on
    (2, 8) becomes (1, 8, T, V/8, D)); on "process_group" this rank's block
    alone, (1, …, 1, local block…).  The result never shares memory with `x`."""
    dims = _dims(x, spec, mesh)
    if mesh.backend == "process_group":
        coords = np.unravel_index(int(mesh.local_engines[0]), mesh.axis_sizes)
        coord = dict(zip(mesh.axis_names, (int(c) for c in coords)))
        for i, axes in enumerate(dims):
            if axes:
                sizes = [mesh.shape[a] for a in axes]
                k = int(np.ravel_multi_index([coord[a] for a in axes], sizes))
                chunk = x.shape[i] // int(np.prod(sizes))
                x = x.narrow(i, k * chunk, chunk)
        y = x.reshape((1,) * len(mesh.axis_names) + tuple(x.shape))
    else:
        y = _stacked_layout(x, dims, mesh)
    y = y.contiguous()
    return y.clone() if y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr() else y


def unshard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The inverse of `shard_tensor`: the whole tensor from its layout (on
    "process_group", gathered from every rank along the axes the spec
    splits over)."""
    n = len(mesh.axis_names)
    used = {a for s in tuple(spec) if s is not None for a in ((s,) if isinstance(s, str) else s)}
    for a in mesh.axis_names:
        i = mesh.axis_names.index(a)
        if a in used:
            x = mesh.all_gather(x, a)
        else:
            x = x.narrow(i, 0, 1)  # replicated: every engine along it holds the same
    block = x.shape[n:]
    whole = [int(b) for b in block]
    for i, s in enumerate(tuple(spec)):
        if s is not None:
            whole[i] *= int(np.prod([mesh.shape[a] for a in ((s,) if isinstance(s, str) else s)]))
    # invert the stacked layout: engine axes back beside the dims they split
    lead = [mesh.shape[a] if a in used else 1 for a in mesh.axis_names]
    x = x.reshape(*lead, *block)
    order = []
    axis_dim = {a: j for j, a in enumerate(mesh.axis_names)}
    spec_full = tuple(spec) + (None,) * (len(block) - len(tuple(spec)))
    for i, s in enumerate(spec_full):
        axes = () if s is None else ((s,) if isinstance(s, str) else tuple(s))
        order += [axis_dim[a] for a in axes] + [n + i]
    unused = [axis_dim[a] for a in mesh.axis_names if a not in used]
    return x.permute(*order, *unused).reshape(whole)


# ------------------------- inside the per-engine work --------------------------


def gather_dim(mesh, t: torch.Tensor, axes: tuple[str, ...], dim: int) -> torch.Tensor:
    """`t` (local engines…, …), its dim `dim` (absolute) split over `axes` in
    that order (`shard_tensor`'s layout): the whole dim, held once along
    `axes`.  On "process_group" `all_gather` along each axis first; on
    "stacked" the blocks are already there, and both reassemble the dim by
    one reshape.  The transpose hands each engine its block of the
    cotangent."""
    n = len(mesh.axis_names)
    for a in axes:
        t = mesh.all_gather(t, a)
    idx = [mesh.axis_index(a) for a in axes]
    others = [i for i in range(n) if i not in idx]
    order = others + list(range(n, dim)) + idx + list(range(dim, t.dim()))
    t = t.permute(order)
    k = len(others) + dim - n
    shape = list(t.shape)
    t = t.reshape(*shape[:k], -1, *shape[k + len(idx) + 1:])
    for i in sorted(idx):
        t = t.unsqueeze(i)
    return t


def own_block(mesh, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """`t` (local engines…, …), the same on every engine along `axis` (its
    local axis full there: entered), cut along `dim` (absolute) into the
    axis's size blocks: each engine's block at its coordinate."""
    a, size = mesh.axis_index(axis), mesh.shape[axis]
    t = t.unflatten(dim, (size, t.shape[dim] // size))
    local = mesh.local_coords(axis)  # consecutive: every coordinate on "stacked", one on "process_group"
    coords = torch.arange(int(local[0]), int(local[0]) + len(local), device=t.device)  # no host copy: capturable
    shape = [1] * t.dim()
    shape[a] = len(coords)
    index = coords.view(shape).expand(*t.shape[:dim], 1, *t.shape[dim + 1:])
    return torch.gather(t, dim, index).squeeze(dim)
