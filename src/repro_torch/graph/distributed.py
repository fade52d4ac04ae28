"""Distributed vertex-centric execution over a 1-D engine mesh (the port of
`repro.graph.distributed`).

The engines are the paper's: vertices are dealt to them by Algorithm 2
(degree-sorted cyclic), edges are source-cut, so Process reads are
engine-local.  Reduce delivery is a combiner exchange: each engine reduces its
outgoing messages *per destination engine* into a (P, n_local) partial block,
one `all_to_all` delivers every partial to its owner (P·n_local·itemsize
bytes an engine, whatever the edge count), and the owner folds the P partials
and applies the update.  `core.mapping.DeviceMapper` picks which device runs
which engine (`site_permutation`), the paper's placement step; the optional
`comm_dtype` casts the partials for the exchange (bf16 halves its bytes).

`EngineMesh` is the port of the reference's meshes: the one-axis
`("engines",)` mesh of these paths (`make_engines_mesh`), and a mesh over
named axes such as `("data", "model")` (`make_mesh`; `launch/mesh.py` builds
the production one) for the model paths.  Every per-engine body is written
once over a leading block of *local-engine* axes, one an axis (L below for
one axis), and the mesh has two backends:

  * "stacked"       — all P engines on one device (L = P): the exchange is the
                      swap of the first two axes, a copy on the card.  This is
                      how one GPU runs P engines, the counterpart of the
                      reference's `--xla_force_host_platform_device_count`.
  * "process_group" — one engine a rank (L = 1) of the default
                      `torch.distributed` group, initialised by the caller:
                      NCCL for a CUDA mesh, gloo for a CPU one.  `site_permutation[p]` is the rank that
                      runs engine p; a collective along one axis of several
                      runs in that axis's subgroup of the rank's row.

Both fold partials and per-engine scalars in engine order (`fold`, never a
reduction whose order depends on the tensor's shape), so the two backends give
the same bits.

Training goes through the collectives.  On "stacked" autograd differentiates
the swap and the fold; on "process_group" the raw collectives are
`torch.autograd.Function`s: the exchange's transpose is the same exchange,
and a gather's output is the same on every engine of the row (each holds the
whole cotangent, as replicated work computes it on every process), so its
transpose is the engine's own block of the cotangent; `psum`, a fold of the
gather, passes the cotangent through to each engine's contribution.  Where a
tensor that every engine holds alike (a weight, the token batch) enters
per-engine work, the caller says so with `enter`: its backward sums the
engines' cotangents over the axes it was replicated on, in engine order
(Megatron's *f*; the transpose of JAX's `pvary`).  Nothing else sums a
gradient over engines: work done alike on every process (dcn-v2's dense
layers after the data gather, the transformer around EP) already leaves the
whole gradient on each, and a sum there would count it once an engine.

PageRank (a sum program whose process is the weighted product) reduces its
partials through `kernels.segment_spmm`, one launch a step for all local
engines: one ELL a run, block-diagonal over them, rows (engine, dst_key) and
columns (engine, src_slot), the edge weights in the ELL.  BFS and SSSP (min)
gather, process and `VertexProgram.segment_reduce`, as the one-device engine
does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.partition import Partition
from repro_torch.device import resolve_device
from repro_torch.graph.structs import EllBlocks, HostGraph, build_ell
from repro_torch.graph.vertex_program import VertexProgram
from repro_torch.kernels.segment_spmm.ops import segment_spmm

__all__ = ["EngineMesh", "make_mesh", "make_engines_mesh", "fold", "engine_sums", "ShardedVertexGraph",
           "DistributedEngine", "MESH_BACKENDS"]

Tensor = torch.Tensor
MESH_BACKENDS = ("stacked", "process_group")
_FOLD_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def fold(x: Tensor, dim: int, kind: str = "sum") -> Tensor:
    """Reduce `x` along `dim` one slice at a time, in index order: the same
    additions whatever the other dimensions, so a stacked (L, P, …) tensor and
    a rank's (1, P, …) one fold alike."""
    op = _FOLD_OPS[kind]
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = op(out, x.select(dim, i))
    return out


def engine_sums(x: Tensor, dtype: torch.dtype | None = None) -> Tensor:
    """x (L, …) → (L,): each local engine's sum, taken over its own slice, so
    its additions do not depend on how many engines are stacked beside it."""
    return torch.stack([x[i].sum(dtype=dtype) for i in range(x.shape[0])])


@dataclasses.dataclass(frozen=True, eq=False)
class EngineMesh:
    """A mesh of engines on `device`, over the named axes `axis_names` of
    sizes `axis_sizes` (row-major; an int n: the 1-D mesh `("engines",)` ×
    n).  `shape` maps each axis to its size, as a JAX mesh's does.

    Tensors carry a leading block of local-engine axes, one an axis: the
    axis's size on the "stacked" backend, 1 on "process_group".  A tensor
    that is the same on every engine along an axis may hold 1 there instead
    (broadcast), as `models.sharding.shard_tensor` lays out a replicated
    one.  `site_permutation[p]` is the device of engine p, p the row-major
    engine index: the rank that runs it on "process_group"; on "stacked"
    every engine is on the one device, in engine order.  Build it with
    `make_mesh` (or `make_engines_mesh` for one axis).

    The collectives act along one named axis, within each row of the other
    axes; without an axis, along every axis (the 1-D API).  On
    "process_group" each axis's rows are subgroups (`dist.new_group`) that
    every rank creates in the same order when the mesh is made."""

    axis_sizes: int | tuple[int, ...]
    device: torch.device
    backend: str = "stacked"
    site_permutation: np.ndarray | None = None
    axis_names: tuple[str, ...] = ("engines",)
    # process_group: for each axis, (this rank's subgroup or None for the whole
    # world, group rank of each coordinate along the axis in this rank's row)
    _groups: tuple | None = None

    def __post_init__(self):
        if isinstance(self.axis_sizes, int):
            object.__setattr__(self, "axis_sizes", (self.axis_sizes,))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} of sizes {self.axis_sizes}")

    @property
    def num_engines(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def _perm(self) -> np.ndarray:
        p = self.site_permutation
        return np.arange(self.num_engines) if p is None else np.asarray(p, dtype=np.int64)

    @property
    def local_engines(self) -> np.ndarray:
        """The engines this process holds (row-major indices), in the order of
        its local axes."""
        if self.backend == "stacked":
            return np.arange(self.num_engines)
        return np.nonzero(self._perm == dist.get_rank())[0]

    @property
    def local_shape(self) -> tuple[int, ...]:
        """The local-engine axes' sizes: the mesh's on "stacked", 1s on "process_group"."""
        return self.axis_sizes if self.backend == "stacked" else (1,) * len(self.axis_sizes)

    def local_coords(self, axis: str) -> np.ndarray:
        """The coordinates along `axis` of this process's engines, in local order."""
        a = self.axis_index(axis)
        if self.backend == "stacked":
            return np.arange(self.axis_sizes[a])
        return np.asarray([np.unravel_index(int(self.local_engines[0]), self.axis_sizes)[a]])

    def local_slices(self) -> tuple[slice, ...]:
        """Index of this process's block in a tensor laid out over all engines."""
        if self.backend == "stacked":
            return (slice(None),) * len(self.axis_sizes)
        coords = np.unravel_index(int(self.local_engines[0]), self.axis_sizes)
        return tuple(slice(int(c), int(c) + 1) for c in coords)

    def axis_index(self, axis: str | None) -> int:
        if axis is None:
            if len(self.axis_names) != 1:
                raise ValueError(f"a mesh of axes {self.axis_names} needs the axis named")
            return 0
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in the mesh's {self.axis_names}")
        return self.axis_names.index(axis)

    def all_to_all(self, x: Tensor, axis: str | None = None) -> Tensor:
        """x (local engines…, S, …), S the axis's size: block j of each engine
        is for the engine at coordinate j along `axis` in its row.  Returns the
        same shape: block i is what the engine at coordinate i sent it.  On
        "stacked", the swap of the axis with the block axis.  Its transpose is
        itself."""
        a, n = self.axis_index(axis), len(self.axis_sizes)
        if self.backend == "stacked":
            return x.transpose(a, n).contiguous()
        group, grank = self._groups[a]
        grank = torch.from_numpy(grank).to(x.device)
        lead = x.shape[:n]
        send = x.reshape(x.shape[n:]).index_select(0, torch.argsort(grank))  # block k goes to group rank k
        recv = _GroupAllToAll.apply(send, group)
        return recv.index_select(0, grank).reshape(*lead, *recv.shape)  # block i arrived from grank[i]

    def all_gather(self, x: Tensor, axis: str | None = None) -> Tensor:
        """Every engine's block along `axis`, in coordinate order: the local
        axis grows to the axis's size (on "stacked" `x` is returned as it
        is).  Without an axis on a 1-D mesh: x (L, …) → (P, …)."""
        if self.backend == "stacked":
            return x
        if axis is None and len(self.axis_names) > 1:
            for name in self.axis_names:
                x = self.all_gather(x, name)
            return x
        a = self.axis_index(axis)
        group, grank = self._groups[a]
        parts = _GroupAllGather.apply(x.contiguous(), group)  # (group size, …) in group-rank order
        return torch.cat([parts[r] for r in grank], dim=a)

    def psum(self, x: Tensor, axis: str | None = None) -> Tensor:
        """The sum over the engines along `axis`, added in engine order
        (`fold`), kept as a local axis of size 1 (the same on every engine of
        the row).  Without an axis: x (local engines…, …) → (…), the sum over
        every engine in row-major engine order."""
        n = len(self.axis_sizes)
        if axis is None:
            full = self.all_gather(x)
            return fold(full.reshape(-1, *full.shape[n:]), 0)
        a = self.axis_index(axis)
        return fold(self.all_gather(x, axis), a).unsqueeze(a)

    def enter(self, x: Tensor, axes: str | tuple[str, ...] | None = None) -> Tensor:
        """`x` (local engines…, …), the same on every engine along `axes`
        (None: every axis) and held once there (size 1 on those local axes),
        as per-engine work reads it: one copy a local engine along `axes` (on
        "stacked" an expanded view; on "process_group" `x` itself).  The
        forward moves nothing.  The backward sums each engine's cotangent
        over `axes`, one axis at a time in the mesh's order and along each in
        engine order (`fold` on "stacked", `psum` on "process_group"), so the
        two backends give the same bits, and leaves the sum, the whole
        gradient, on every engine (size 1 again)."""
        names = self.axis_names if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
        dims = tuple(sorted(self.axis_index(name) for name in names))
        if any(x.shape[a] != 1 for a in dims):
            raise ValueError(f"enter: a tensor of shape {tuple(x.shape)} is not held once along {names}")
        return _Enter.apply(x, self, dims)


class _GroupAllToAll(torch.autograd.Function):
    """`dist.all_to_all_single` over `group`: block k of `send` goes to group
    rank k.  The exchange is its own transpose: the cotangent of the block
    that came from rank k goes back to rank k."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv

    @staticmethod
    def backward(ctx, g):
        return _GroupAllToAll.forward(ctx, g.contiguous(), ctx.group), None


class _GroupAllGather(torch.autograd.Function):
    """`dist.all_gather` over `group`: (group size, …), block k from group
    rank k.  The result is the same on every rank of the group, and each
    holds the whole cotangent of it, so the transpose is this rank's own
    block (a sum over the ranks would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        return g[dist.get_rank(ctx.group)], None


class _Enter(torch.autograd.Function):
    """`EngineMesh.enter`: identity forward (a view expanded over `dims` on
    "stacked"), the engines' cotangents summed over `dims` backward."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        if mesh.backend == "stacked":
            return x.expand(*(mesh.axis_sizes[i] if i in dims else -1 for i in range(x.dim())))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        for a in ctx.dims:
            g = fold(g, a).unsqueeze(a) if mesh.backend == "stacked" else mesh.psum(g, mesh.axis_names[a])
        return g, None, None


def _axis_groups(sizes: tuple[int, ...], perm: np.ndarray, rank: int) -> tuple:
    """For each axis, (this rank's subgroup, the group rank of each coordinate
    along the axis in its row).  Every rank creates every row's subgroup, axis
    by axis and row by row in row-major order, as `dist.new_group` requires; a
    row that spans the whole world is the default group (None)."""
    engines = np.arange(int(np.prod(sizes))).reshape(sizes)
    out = []
    for a, size in enumerate(sizes):
        mine = None
        for row in np.moveaxis(engines, a, -1).reshape(-1, size):
            ranks = perm[row]
            group = None if len(row) == len(perm) else dist.new_group(sorted(ranks.tolist()))
            if rank in ranks:
                mine = (group, np.argsort(np.argsort(ranks)))  # a group's ranks are its members in sorted order
        out.append(mine)
    return tuple(out)


def make_mesh(
    shape,
    axes,
    *,
    site_permutation: np.ndarray | None = None,
    backend: str = "stacked",
    device: str | torch.device | None = None,
) -> EngineMesh:
    """A mesh of `shape` engines over the named `axes` (e.g. (2, 8) over
    ("data", "model")); `site_permutation[p]` = the device of engine p, p the
    row-major engine index.

    "stacked" (the default): every engine on `device` (None: the card).
    "process_group": one engine a rank of the initialised default group,
    whose size must be the engine count and whose backend must be NCCL for a
    CUDA `device` and gloo for the CPU; each axis's subgroups are made here,
    by every rank in the same order."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"a mesh of shape {shape} over axes {axes}")
    dev = resolve_device(device)
    if backend not in MESH_BACKENDS:
        raise ValueError(f"unknown mesh backend {backend!r}; options: {'|'.join(MESH_BACKENDS)}")
    num = int(np.prod(shape))
    perm = None
    if site_permutation is not None:
        perm = np.asarray(site_permutation, dtype=np.int64)
        if not np.array_equal(np.sort(perm), np.arange(num)):
            raise ValueError(f"site_permutation {perm.tolist()} is not a permutation of {num} engines")
    groups = None
    if backend == "process_group":
        _check_process_group(dev)
        world = dist.get_world_size()
        if num != world:
            raise ValueError(f"one engine a rank: {num} engines on {world} ranks")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        groups = _axis_groups(shape, np.arange(num) if perm is None else perm, dist.get_rank())
    return EngineMesh(shape, dev, backend, perm, axes, groups)


def _check_process_group(dev: torch.device) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the process_group mesh needs torch.distributed initialised by the caller")
    want = "nccl" if dev.type == "cuda" else "gloo"
    got = dist.get_backend()
    if got != want:
        raise ValueError(f"a {dev.type} mesh runs over {want}; the process group runs {got}")


def make_engines_mesh(
    site_permutation: np.ndarray | None = None,
    *,
    num_engines: int | None = None,
    backend: str = "stacked",
    device: str | torch.device | None = None,
) -> EngineMesh:
    """1-D 'engines' mesh; `site_permutation[p]` = the device of engine p.

    "stacked" (the default): `num_engines` engines (else the permutation's
    length, else 1) on `device` (None: the card).  "process_group": one engine
    a rank of the initialised default group, whose backend must be NCCL for a
    CUDA `device` and gloo for the CPU."""
    dev = resolve_device(device)
    if backend == "process_group":
        _check_process_group(dev)
        world = dist.get_world_size()
        if num_engines is not None and num_engines != world:
            raise ValueError(f"one engine a rank: {num_engines} engines on {world} ranks")
        num_engines = world
    if num_engines is None:
        num_engines = 1 if site_permutation is None else len(site_permutation)
    return make_mesh((num_engines,), ("engines",), site_permutation=site_permutation, backend=backend, device=dev)


@dataclasses.dataclass
class ShardedVertexGraph:
    """Static-shape engine-sharded graph, host numpy: every (P, ·) array has a
    row an engine.  `rehomed_edges` counts the edges the capacity spill had
    put on an engine that does not own their source, moved back to it."""

    num_devices: int
    num_nodes: int
    n_local: int  # owned vertex slots per engine (padded)
    e_local: int  # edge slots per engine (padded)
    src_slot: np.ndarray  # (P, E) int32 local slot of the edge source
    dst_key: np.ndarray  # (P, E) int32 dst_part * n_local + dst_slot
    weight: np.ndarray  # (P, E) float32
    valid: np.ndarray  # (P, E) bool
    slot_to_vertex: np.ndarray  # (P, n_local) inverse map (sentinel -1)
    rehomed_edges: int = 0

    @staticmethod
    def build(g: HostGraph, partition: Partition) -> "ShardedVertexGraph":
        Pn = partition.num_parts
        n = g.num_nodes
        # slot(v) = rank of v inside its part, in sorted order (cyclic deal ⇒
        # slot = position // P for the powerlaw partitioner; computed
        # generically so random/range/hash partitions work too).
        pos = np.empty(n, dtype=np.int64)
        pos[partition.order] = np.arange(n)
        order_in_part = np.lexsort((pos, partition.vertex_part))
        slot = np.empty(n, dtype=np.int64)
        counts = np.bincount(partition.vertex_part, minlength=Pn)
        n_local = int(counts.max())
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot[order_in_part] = np.arange(n) - np.repeat(offs, counts)
        vpart = partition.vertex_part.astype(np.int64)

        slot_to_vertex = np.full((Pn, n_local), -1, dtype=np.int64)
        slot_to_vertex[vpart, slot] = np.arange(n)

        # Edges grouped by their (source-cut) part.
        epart = partition.edge_part.astype(np.int64)
        ecounts = np.bincount(epart, minlength=Pn)
        e_local = int(ecounts.max()) if ecounts.size else 1
        eorder = np.argsort(epart, kind="stable")
        eoffs = np.concatenate([[0], np.cumsum(ecounts)[:-1]])
        row = np.repeat(np.arange(Pn), ecounts)
        col = np.arange(g.num_edges) - np.repeat(eoffs, ecounts)

        src_slot = np.zeros((Pn, e_local), dtype=np.int32)
        dst_key = np.full((Pn, e_local), Pn * n_local, dtype=np.int32)  # sentinel key
        weight = np.zeros((Pn, e_local), dtype=np.float32)
        valid = np.zeros((Pn, e_local), dtype=bool)
        es, ed = g.src[eorder], g.dst[eorder]
        # An edge the capacity spill put on a part that does not own its
        # source is re-homed to the source's part, and the packing redone.
        bad = vpart[es] != row
        if bad.any():
            row = np.where(bad, vpart[es], row)
            order2 = np.argsort(row, kind="stable")
            row, es, ed = row[order2], es[order2], ed[order2]
            w_src = None if g.weight is None else g.weight[eorder][order2]
            ecounts = np.bincount(row, minlength=Pn)
            e_local = int(ecounts.max())
            eoffs = np.concatenate([[0], np.cumsum(ecounts)[:-1]])
            col = np.arange(g.num_edges) - np.repeat(eoffs, ecounts)
            src_slot = np.zeros((Pn, e_local), dtype=np.int32)
            dst_key = np.full((Pn, e_local), Pn * n_local, dtype=np.int32)
            weight = np.zeros((Pn, e_local), dtype=np.float32)
            valid = np.zeros((Pn, e_local), dtype=bool)
        else:
            w_src = None if g.weight is None else g.weight[eorder]

        src_slot[row, col] = slot[es]
        dst_key[row, col] = (vpart[ed] * n_local + slot[ed]).astype(np.int32)
        weight[row, col] = 1.0 if w_src is None else w_src
        valid[row, col] = True

        return ShardedVertexGraph(
            num_devices=Pn,
            num_nodes=n,
            n_local=n_local,
            e_local=e_local,
            src_slot=src_slot,
            dst_key=dst_key,
            weight=weight,
            valid=valid,
            slot_to_vertex=slot_to_vertex,
            rehomed_edges=int(bad.sum()),
        )

    def exchange_bytes(self, itemsize: int = 4) -> int:
        """Bytes one step's exchange moves over the whole mesh: P·P·n_local
        partials (each engine's own block included)."""
        return self.num_devices * self.num_devices * self.n_local * itemsize


def partial_ell(sg: ShardedVertexGraph, engines: np.ndarray, device: torch.device) -> EllBlocks:
    """The ELL of the per-destination partial reduce of `engines`, stacked
    block-diagonally: local engine l's rows are l·P·n_local + dst_key, its
    columns l·n_local + src_slot, its weights the edge weights; square, of
    L·P·n_local vertices.  A row adds its edges in the engine's edge order,
    wherever the engine sits in the stack."""
    L, P, n_local = len(engines), sg.num_devices, sg.n_local
    keep = sg.valid[engines]
    local = np.arange(L, dtype=np.int64)[:, None]
    src = (local * n_local + sg.src_slot[engines])[keep]
    dst = (local * (P * n_local) + sg.dst_key[engines])[keep]
    g = HostGraph(L * P * n_local, src, dst, sg.weight[engines][keep])
    return build_ell(g.reversed(), device=device)


class DistributedEngine:
    """Runs a VertexProgram over a ShardedVertexGraph on an `EngineMesh`."""

    def __init__(self, program: VertexProgram, mesh: EngineMesh, *, comm_dtype: torch.dtype | None = None):
        self.program = program
        self.mesh = mesh
        self.comm_dtype = comm_dtype  # e.g. torch.bfloat16 → compressed exchange

    def _uses_ell(self) -> bool:
        return self.program.default_reduce_impl() == "ell"

    def init_state(self, sg: ShardedVertexGraph, source: int = 0) -> tuple[Tensor, Tensor]:
        """(props, active) of the local engines, (L, n_local + 1) each (one
        sentinel slot an engine), on the mesh's device."""
        dev = resolve_device(self.mesh.device)
        props_g, active_g = (t.numpy() for t in self.program.init(sg.num_nodes, source, torch.device("cpu")))
        props = np.full((sg.num_devices, sg.n_local + 1), props_g[-1], np.float32)
        active = np.zeros((sg.num_devices, sg.n_local + 1), bool)
        s2v = sg.slot_to_vertex
        ok = s2v >= 0
        props[:, :-1][ok] = props_g[s2v[ok]]
        active[:, :-1][ok] = active_g[s2v[ok]]
        rows = self.mesh.local_engines
        return torch.from_numpy(props[rows]).to(dev), torch.from_numpy(active[rows]).to(dev)

    def step_fn(self, sg: ShardedVertexGraph, aux: dict | None = None):
        """`step(props, active) -> (props, active, delta)` over the local
        engines' edges, moved to the mesh's device once here (and, for an
        ELL program, its partial-reduce ELL built once).  `delta` is the
        mesh-wide Σ|Δprops| (float64; None for a program with the "delta"
        frontier, which stops on its frontier).  `aux`: the program's scalar
        aux values."""
        dev = resolve_device(self.mesh.device)
        prog, mesh = self.program, self.mesh
        P, n_local = sg.num_devices, sg.n_local
        if P != mesh.num_engines:
            raise ValueError(f"the graph is sharded over {P} engines, the mesh has {mesh.num_engines}")
        rows = mesh.local_engines
        L = len(rows)
        aux = {k: torch.as_tensor(v, device=dev) for k, v in (aux or {}).items()}
        identity = prog.identity
        ell = partial_ell(sg, rows, dev) if self._uses_ell() else None
        if ell is None:
            src_slot = torch.from_numpy(sg.src_slot[rows].astype(np.int64)).to(dev)
            width = P * n_local + 1  # one sentinel key an engine
            keys = torch.from_numpy(
                (sg.dst_key[rows].astype(np.int64) + np.arange(L)[:, None] * width).reshape(-1)).to(dev)
            weight = torch.from_numpy(sg.weight[rows]).to(dev)
            valid = torch.from_numpy(sg.valid[rows]).to(dev)

        def partials(props: Tensor, active: Tensor) -> Tensor:
            if ell is not None:
                x = torch.where(active[:, :n_local], props[:, :n_local], torch.zeros((), device=dev))
                xs = props.new_zeros((ell.num_nodes, 1))
                xs[: L * n_local, 0] = x.reshape(-1)
                return segment_spmm(xs, ell).view(L, P, n_local)
            msg_active = torch.gather(active, 1, src_slot) & valid
            msg = prog.process(torch.gather(props, 1, src_slot), weight, aux)
            msg = torch.where(msg_active, msg, torch.full((), identity, dtype=msg.dtype, device=dev))
            red = prog.segment_reduce(msg.reshape(-1), keys, L * width)
            return red.view(L, width)[:, :-1].reshape(L, P, n_local)

        def step(props: Tensor, active: Tensor):
            partial = partials(props, active)
            if self.comm_dtype is not None:
                partial = partial.to(self.comm_dtype)
            received = mesh.all_to_all(partial).float()  # row i: engine i's partial for me
            temp = fold(received, 1, prog.reduce_kind)
            temp = torch.cat([temp, temp.new_full((L, 1), identity)], dim=1)
            new_props = prog.apply(props, temp, aux)
            new_props[:, -1] = props[:, -1]
            if prog.frontier == "delta":
                new_active = new_props != props
                new_active[:, -1] = False
                return new_props, new_active, None
            d = torch.nan_to_num(new_props - props, posinf=0.0).abs()
            return new_props, active, mesh.psum(engine_sums(d, torch.float64))

        return step

    def run(
        self,
        g: HostGraph,
        partition: Partition,
        *,
        source: int = 0,
        max_iterations: int = 200,
    ) -> tuple[np.ndarray, int]:
        """Build, shard, iterate until the frontier is empty (frontier
        "delta") or Σ|Δ| ≤ tol ("all"), gather to host order.  Returns
        (props (N,) float32, iterations); every rank returns the whole."""
        resolve_device(self.mesh.device)
        sg = ShardedVertexGraph.build(g, partition)
        # per-vertex aux arrays are not supported in the distributed engine;
        # PageRank folds 1/outdeg into edge weights (algorithms.prepare_graph).
        aux = {k: v for k, v in self.program.make_aux(g).items() if np.ndim(v) == 0}
        props, active = self.init_state(sg, source)
        step = self.step_fn(sg, aux)
        it = 0
        while it < max_iterations:
            if self.program.frontier == "delta" and not self._any_active(active):
                break
            props, active, delta = step(props, active)
            it += 1
            if self.program.frontier == "all" and float(delta) <= self.program.tol:
                break
        out = np.full(g.num_nodes, np.nan, np.float32)
        host = self.mesh.all_gather(props)[:, :-1].cpu().numpy()
        ok = sg.slot_to_vertex >= 0
        out[sg.slot_to_vertex[ok]] = host[ok]
        return out, it

    def _any_active(self, active: Tensor) -> bool:
        return float(self.mesh.psum(active[:, :-1].any(dim=1).to(torch.float32))) > 0
