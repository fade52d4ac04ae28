"""Vertex-centric Process → Reduce → Apply engine in PyTorch (paper Algorithm 1).

Algorithms are `VertexProgram`s (Table 1 rows); the engine runs full-sweep
iterations with masked frontiers, either to convergence (`run`, a Python loop
with one scalar device→host read per iteration) or traced (`run_traced`,
recording per-edge activity per iteration).  The recorded activity feeds
`repro_torch.core.traffic` exactly like the paper's modified-GraphMAT traces
feed their simulator.

Conventions: vertex arrays carry one sentinel row (index N) so padded edges
are harmless; messages from inactive edges carry the reduce identity.

Sum-reduce has two implementations, chosen by `reduce_impl`:
  * "ell"     — the degree-binned ELL SpMM kernel
                (`repro_torch.kernels.segment_spmm`), for a program whose
                `process` is declared to be the weighted product `p * w`
                (`process_kind="weighted_product"`, PageRank).  The ELL
                buckets of the reversed graph are built once per run.
  * "scatter" — `index_add_` over the COO edges, the literal counterpart of a
                segment sum.
`reduce_impl=None` takes "ell" for a sum program that declares the weighted
product and "scatter" for every other program; the choice follows the
program's declaration, never a caught failure.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.graph.structs import EdgeList, EllBlocks, HostGraph, build_ell, to_device_edges
from repro_torch.kernels.segment_spmm.ops import segment_spmm

__all__ = ["VertexProgram", "RunResult", "TraceResult", "run", "run_traced", "REDUCE_IMPLS"]

Tensor = torch.Tensor
REDUCE_IMPLS = ("ell", "scatter")


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """One Table 1 row.  All callables take and return torch tensors."""

    name: str
    reduce_kind: str  # "min" | "sum" | "max"
    # process(src_prop, edge_weight, aux) -> message along the edge
    process: typing.Callable[[Tensor, Tensor, dict], Tensor]
    # apply(prop, temp, aux) -> new prop
    apply: typing.Callable[[Tensor, Tensor, dict], Tensor]
    # init(num_nodes, source, device) -> (props, active) both length N+1 (sentinel row)
    init: typing.Callable[[int, int, torch.device], tuple[Tensor, Tensor]]
    # aux(graph) -> dict of precomputed per-vertex arrays (e.g. out-degree)
    make_aux: typing.Callable[[HostGraph], dict] = lambda g: {}
    # frontier semantics: "delta" re-activates changed vertices, "all" keeps
    # every vertex active each iteration (PageRank-style)
    frontier: str = "delta"
    # convergence tolerance for frontier="all" programs
    tol: float = 1e-6
    # what `process` computes, as far as the engine may rely on it:
    # "weighted_product" declares process(p, w, aux) == p * w, which lets a
    # sum-reduce run as an SpMM; "generic" promises nothing.
    process_kind: str = "generic"

    @property
    def identity(self) -> float:
        return {"min": float("inf"), "max": -float("inf"), "sum": 0.0}[self.reduce_kind]

    def segment_reduce(self, data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
        """Reduce `data` by `segment_ids` (int64) into `num_segments` rows that
        start at the reduce identity."""
        out = torch.full((num_segments,), self.identity, dtype=data.dtype, device=data.device)
        if self.reduce_kind == "min":
            return out.scatter_reduce_(0, segment_ids, data, "amin", include_self=True)
        if self.reduce_kind == "max":
            return out.scatter_reduce_(0, segment_ids, data, "amax", include_self=True)
        return out.index_add_(0, segment_ids, data)

    def default_reduce_impl(self) -> str:
        if self.reduce_kind == "sum" and self.process_kind == "weighted_product":
            return "ell"
        return "scatter"


@dataclasses.dataclass
class RunResult:
    props: np.ndarray  # (N,) final vertex properties (sentinel dropped)
    num_iterations: int


@dataclasses.dataclass
class TraceResult:
    props: np.ndarray
    num_iterations: int
    # per-edge count of iterations in which the edge carried a message —
    # the trace the paper's simulator consumes (via traffic_from_partition).
    edge_activity: np.ndarray
    # per-vertex count of iterations in which apply changed the vertex
    vertex_activity: np.ndarray
    # per-iteration frontier sizes (diagnostics)
    frontier_sizes: list[int]


@dataclasses.dataclass
class _Prepared:
    """What one run keeps on the device: edges with int64 index copies (torch's
    scatter ops index with int64), edge weights, aux arrays, ELL buckets."""

    edges: EdgeList
    src: Tensor
    dst: Tensor
    weight: Tensor
    aux: dict
    ell: EllBlocks | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolve_reduce_impl(program: VertexProgram, reduce_impl: str | None) -> str:
    if reduce_impl is None:
        return program.default_reduce_impl()
    if reduce_impl not in REDUCE_IMPLS:
        raise ValueError(f"unknown reduce_impl {reduce_impl!r}; options: ell|scatter")
    if reduce_impl == "ell" and program.default_reduce_impl() != "ell":
        raise ValueError(
            f"reduce_impl='ell' needs a sum program that declares "
            f"process_kind='weighted_product'; {program.name!r} is "
            f"{program.reduce_kind}/{program.process_kind}"
        )
    return reduce_impl


def _prepare(
    g: HostGraph, program: VertexProgram, pad_to: int | None, reduce_impl: str,
    device: torch.device,
) -> _Prepared:
    edges = to_device_edges(g, pad_to=pad_to, device=device)
    weight = (
        edges.weight
        if edges.weight is not None
        else torch.ones(edges.num_edges_padded, dtype=torch.float32, device=device)
    )
    aux = {k: torch.as_tensor(v, device=device) for k, v in program.make_aux(g).items()}
    ell = build_ell(g.reversed(), device=device) if reduce_impl == "ell" else None
    return _Prepared(edges, edges.src.long(), edges.dst.long(), weight, aux, ell)


def _one_iteration(
    program: VertexProgram, prep: _Prepared, props: Tensor, active: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Returns (new_props, new_active, edge_active)."""
    n_sentinel = props.shape[0]  # N + 1
    edge_active = active[prep.src] & prep.edges.valid
    if prep.ell is not None:
        n = n_sentinel - 1
        x = torch.where(active[:n], props[:n], torch.zeros((), dtype=props.dtype, device=props.device))
        temp = torch.zeros(n_sentinel, dtype=props.dtype, device=props.device)
        temp[:n] = segment_spmm(x[:, None], prep.ell)[:, 0]
    else:
        msg = program.process(props[prep.src], prep.weight, prep.aux)
        msg = torch.where(
            edge_active, msg, torch.full((), program.identity, dtype=msg.dtype, device=msg.device)
        )
        temp = program.segment_reduce(msg, prep.dst, n_sentinel)
    new_props = program.apply(props, temp, prep.aux)
    new_props[-1] = props[-1]  # sentinel never changes
    if program.frontier == "delta":
        new_active = new_props != props
        new_active[-1] = False
    else:
        new_active = active
    return new_props, new_active, edge_active


def run(
    g: HostGraph,
    program: VertexProgram,
    *,
    source: int = 0,
    max_iterations: int = 10_000,
    pad_to: int | None = None,
    reduce_impl: str | None = None,
    device: str | torch.device | None = None,
) -> RunResult:
    """Iterate until the frontier is empty (frontier="delta") or the update
    is below `tol` (frontier="all"); one scalar read from the device per
    iteration decides whether to go on."""
    dev = resolve_device(device)
    prep = _prepare(g, program, pad_to, _resolve_reduce_impl(program, reduce_impl), dev)
    props, active = program.init(g.num_nodes, source, dev)
    it = 0
    delta = float("inf")
    while it < max_iterations:
        if program.frontier == "delta":
            if not bool(active.any()):
                break
        elif not delta > program.tol:
            break
        new_props, active, _ = _one_iteration(program, prep, props, active)
        if program.frontier != "delta":
            delta = float(
                torch.nan_to_num(new_props - props, posinf=0.0).abs().sum(dtype=torch.float64)
            )
        props = new_props
        it += 1
    return RunResult(props[:-1].cpu().numpy(), it)


def run_traced(
    g: HostGraph,
    program: VertexProgram,
    *,
    source: int = 0,
    max_iterations: int = 200,
    pad_to: int | None = None,
    reduce_impl: str | None = None,
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> TraceResult:
    """Execution that records the communication trace (per-edge/vertex
    activity) for the NoC simulator.  The activity counters and the frontier
    sizes stay on the device while the loop runs and come to the host once at
    the end.  A `timings` dict, when given, receives `prepare_s` (edges, aux
    and ELL buckets onto the device) and `loop_s` (the iterations and the
    final copy back), each closed by a device synchronise."""
    dev = resolve_device(device)
    t_start = obs.now_s()
    prep = _prepare(g, program, pad_to, _resolve_reduce_impl(program, reduce_impl), dev)
    props, active = program.init(g.num_nodes, source, dev)
    if timings is not None:
        _sync(dev)
        timings["prepare_s"] = obs.now_s() - t_start
        t_start = obs.now_s()

    e_real = g.num_edges
    edge_activity = torch.zeros(prep.edges.num_edges_padded, dtype=torch.int32, device=dev)
    vertex_activity = torch.zeros(g.num_nodes, dtype=torch.int32, device=dev)
    frontier_sizes: list[Tensor] = []
    it = 0
    while it < max_iterations:
        if program.frontier == "delta" and not bool(active.any()):
            break
        new_props, new_active, edge_active = _one_iteration(program, prep, props, active)
        edge_activity += edge_active
        vertex_activity += (new_props != props)[:-1]
        frontier_sizes.append(edge_active.sum())
        if program.frontier == "all":
            delta = float(
                torch.nan_to_num((new_props - props).abs(), posinf=0.0).sum(dtype=torch.float64)
            )
        props, active = new_props, new_active
        it += 1
        if program.frontier == "all" and delta <= program.tol:
            break
    sizes = torch.stack(frontier_sizes).cpu().tolist() if frontier_sizes else []
    result = TraceResult(
        props=props[:-1].cpu().numpy(),
        num_iterations=it,
        edge_activity=edge_activity[:e_real].cpu().numpy().astype(np.float64),
        vertex_activity=vertex_activity.cpu().numpy().astype(np.float64),
        frontier_sizes=[int(s) for s in sizes],
    )
    if timings is not None:
        _sync(dev)
        timings["loop_s"] = obs.now_s() - t_start
    return result
