"""The degraded windowed-NoC arm: mid-replay link failures in both backends.

One degraded replay is two segments of the existing window recursion
(`nocsim.batch.open_step` under the shared `run_windows` carry runner — the
steppers are reused verbatim, so the fault arm cannot drift from the
pristine arm's semantics; with `flow_control="credit"` the two segments run
`nocsim.credit` instead, same boundary protocol, credit state carried):

  segment 1  windows [0, fail_window)   — pristine dimension-ordered routes;
  boundary   the backlog stranded on each newly-dead link is redistributed
             onto the links of that dead link's detour path (shared float64
             numpy on BOTH backends' own carries);
  segment 2  windows [fail_window, W)   — fault-aware detour routes
             (`route_links_faulty`), derated links inflated by 1/γ.

On the torch backend both segments run on the device; the carry crosses to
the host for the redistribution and back once, at the failure window.

Normalisation: the recursion runs in units of one window's full-bandwidth
service (cap = window_s·bw exactly, see `build_schedule`).  A derated link
serving γ·bw is modelled by scaling its injected bytes by 1/γ — serving 1.0
normalised unit then takes one window regardless of γ — and the timelines
handed to `assemble_result` are `serviced_norm · cap` (full-bandwidth-
equivalent bytes), which keeps every derived time exact.

The capacity budget and the analytic serialization reference stay pinned to
the PRISTINE schedule (`build_schedule`'s peak load), so `contention_excess`
and `t_drain` measure fault-induced slowdown against the fabric the paper
measured — the "win retention vs fault rate" headline.  With an empty
`FaultSet` the detour routes equal the pristine routes, the redistribution
is a no-op, and the two-segment chunked stepping is bit-identical to the
unchunked pristine run (`run_windows`'s property) — so `degraded_batch`
reproduces `contended_batch` bit-for-bit (tested, on BOTH flow-control
arms).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.registry import parity_pair_torch
from repro_torch.core.placement import Placement
from repro_torch.core.simulator import SimParams
from repro_torch.core.traffic import TrafficMatrix
from repro_torch.faults.model import FaultSet
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.faults.routing import effective_dead_links, route_links_faulty
from repro_torch.nocsim.batch import PARITY_RTOL, open_step, run_windows, stacked_open_program
from repro_torch.nocsim.model import (
    ConfigSchedule,
    NocSimParams,
    NocSimResult,
    assemble_result,
    build_schedule,
)
from repro_torch.nocsim.routes import route_operators

__all__ = [
    "DegradedSchedule",
    "build_degraded_schedule",
    "degraded_batch",
    "PARITY_RTOL",
]


@dataclasses.dataclass
class DegradedSchedule:
    """One config's two-segment injection program plus the boundary plan."""

    schedule: ConfigSchedule  # inj = two-segment (W, L); reference terms pristine
    fail_window: int
    # Redistribution plan: (dead link id, (detour link ids), (factors)) —
    # applied to the normalised carry between the segments.
    redistribution: tuple[tuple[int, tuple[int, ...], tuple[float, ...]], ...]
    num_detoured_flows: int
    detour_stretch: float  # byte-weighted mean (detour hops / pristine hops)
    route_inc_pre: np.ndarray  # pristine (L, F) incidence (segment-1 credit)
    gamma: np.ndarray  # (L,) derate factors (1 everywhere pre-fault)


def _link_id_map(link_keys: tuple) -> dict:
    return {k: i for i, k in enumerate(link_keys)}


def build_degraded_schedule(
    traffic: TrafficMatrix,
    placement: Placement,
    faults: FaultSet,
    *,
    noc_params: NocSimParams = NocSimParams(),
    params: SimParams = SimParams(),
    fail_window: int | None = None,
) -> DegradedSchedule:
    """Precompute one config's degraded injection program (float64, shared by
    both backends).  `fail_window` defaults to the replay midpoint; 0 makes
    the whole replay run on the degraded fabric."""
    if noc_params.routing != "dor":
        raise ValueError("the degraded arm models the dimension-ordered policy only")
    base = build_schedule(traffic, placement, noc_params=noc_params, params=params)
    w = noc_params.windows
    fail_w = w // 2 if fail_window is None else int(fail_window)
    if not (0 <= fail_w <= w):
        raise ValueError(f"fail_window {fail_w} outside [0, {w}]")
    topo = placement.topology
    ops = route_operators(topo)
    lid = _link_id_map(ops.link_keys)
    coords = topo.coords()
    n = topo.num_nodes

    # Post-fault route incidence per flow (same flow order as build_schedule:
    # np.nonzero row-major over the traffic matrix).
    m = traffic.bytes_matrix
    ii, jj = np.nonzero(m)
    s = placement.site
    flow_sites = np.stack([s[ii], s[jj]], axis=1)
    num_links = base.route_inc.shape[0]
    route_inc_post = np.zeros_like(base.route_inc)
    hops_post = np.zeros(ii.size, dtype=np.float64)
    dead = effective_dead_links(topo, faults)
    detoured = 0
    route_cache: dict[tuple[int, int], list] = {}
    for f in range(ii.size):
        a, b = int(flow_sites[f, 0]), int(flow_sites[f, 1])
        route = route_cache.get((a, b))
        if route is None:
            route = route_cache[(a, b)] = route_links_faulty(
                topo, tuple(coords[a]), tuple(coords[b]), faults
            )
        hops_post[f] = len(route)
        if len(route) > base.flow_hops[f]:
            detoured += 1
        for key in route:
            route_inc_post[lid[key], f] = 1.0

    # Two-segment injection: pristine windows, then degraded windows with
    # derated links inflated by 1/γ (post-fault only; the fabric is pristine
    # before the failure event).
    phase_onehot = np.equal.outer(base.flow_phase, np.arange(3)).astype(np.float64)
    loads_post = route_inc_post @ (base.flow_bytes[:, None] * phase_onehot)  # (L, 3)
    inj = base.inj.copy()
    inj[fail_w:] = base.window_share[fail_w:] @ loads_post.T
    gamma = np.ones(num_links, dtype=np.float64)
    for key, g in faults.derated_links:
        l = lid.get(key)
        if l is not None:
            gamma[l] = g
    if faults.derated_links:
        inj[fail_w:] = inj[fail_w:] / gamma[None, :]

    # Boundary plan: a dead link's stranded backlog re-enters the fabric
    # along the surviving path between its endpoints, each detour link
    # inflated by its own 1/γ.
    redistribution = []
    ndim = coords.shape[1]
    for key in sorted(dead):
        l = lid.get(key)
        if l is None:
            continue
        detour = route_links_faulty(topo, key[:ndim], key[ndim:], faults)
        ids = tuple(lid[k] for k in detour)
        redistribution.append((l, ids, tuple(1.0 / gamma[i] for i in ids)))

    byte_hops_post = float((base.flow_bytes * hops_post).sum())
    avg_hops_post = byte_hops_post / base.total_bytes if base.total_bytes else 0.0
    per_engine_packets = (base.total_bytes / params.packet_bytes) / max(
        1, traffic.num_parts
    )
    stretch = (
        byte_hops_post / float((base.flow_bytes * base.flow_hops).sum())
        if base.flow_bytes.size and float((base.flow_bytes * base.flow_hops).sum()) > 0
        else 1.0
    )
    schedule = dataclasses.replace(
        base,
        inj=inj,
        route_inc=route_inc_post,
        flow_hops=hops_post,
        avg_hops=avg_hops_post,
        t_sf_s=per_engine_packets * avg_hops_post * params.hop_latency_s,
    )
    return DegradedSchedule(
        schedule=schedule,
        fail_window=fail_w,
        redistribution=tuple(redistribution),
        num_detoured_flows=detoured,
        detour_stretch=float(stretch),
        route_inc_pre=base.route_inc,
        gamma=gamma,
    )


def _apply_redistribution(carry: np.ndarray, plans: list) -> np.ndarray:
    """Move each config's stranded dead-link backlog onto its detour links
    (normalised units; shared float64 numpy on both backends)."""
    out = carry.copy()
    for c, plan in enumerate(plans):
        for l_dead, detour_ids, factors in plan:
            b = out[c, l_dead]
            if b == 0.0:
                continue
            out[c, l_dead] = 0.0
            for m, f in zip(detour_ids, factors):
                out[c, m] += b * f
    return out


@parity_pair_torch(
    serial="repro_torch.nocsim.batch.contended_batch",
    kind="bit",
    note="an empty `FaultSet` reproduces the pristine contended arm "
    "bit-identically on both backends (and the degraded numpy↔torch parity "
    "stays within the 1e-6 gate, measured per faults sweep; "
    "tests/test_torch_faults.py)",
)
def degraded_batch(
    traffics: list[TrafficMatrix],
    placements: list[Placement],
    faultsets: list[FaultSet],
    *,
    noc_params: NocSimParams = NocSimParams(),
    params: SimParams = SimParams(),
    num_iterations: np.ndarray | list[int] | int = 1,
    backend: str = "numpy",
    fail_window: int | None = None,
    schedules: list[DegradedSchedule] | None = None,
    device: str | torch.device | None = None,
) -> list[NocSimResult]:
    """Batched degraded contended simulation: one `NocSimResult` per
    (traffic, placement, faults) triple, in input order.  All configs share
    one stacked two-segment recursion; `schedules` lets the parity caller
    build the programs once for both backends.  `backend` is "numpy",
    "torch" or "auto" (= "torch"); the torch steppers run on `device`
    (`None` is the CUDA device and raises without one)."""
    if not (len(traffics) == len(placements) == len(faultsets)):
        raise ValueError("traffics, placements and faultsets must pair up")
    n_cfg = len(traffics)
    if n_cfg == 0:
        return []
    iters = np.broadcast_to(np.asarray(num_iterations, dtype=np.int64), (n_cfg,))
    backend = resolve_backend(backend)
    dev = resolve_device(device) if backend == "torch" else None
    if schedules is None:
        schedules = [
            build_degraded_schedule(
                t, p, f, noc_params=noc_params, params=params, fail_window=fail_window
            )
            for t, p, f in zip(traffics, placements, faultsets)
        ]
    w = noc_params.windows
    fail_ws = {d.fail_window for d in schedules}
    if len(fail_ws) != 1:
        raise ValueError(f"one stacked run needs one fail_window, got {sorted(fail_ws)}")
    fail_w = fail_ws.pop()
    inj = stacked_open_program([d.schedule for d in schedules], w)
    plans = [list(d.redistribution) for d in schedules]
    if noc_params.flow_control == "credit":
        # Closed-loop composition: the same two-segment structure, with the
        # credit state (src, buf) carried across the failure boundary.  The
        # pre segment runs on the pristine incidence; the post segment on
        # the detour incidence with derated links scaled by 1/γ (a derated
        # link's buffer fills 1/γ faster in normalised units, matching the
        # 1/γ-inflated injections), which preserves the infinite-credit
        # arrivals identity per segment.  At the boundary the source-held
        # state passes through unchanged (held bytes re-bid on the new
        # routes via the post incidence) and the buffered bytes stranded on
        # dead links move to their detour links — the same shared-float64
        # `_apply_redistribution` as the open arm, applied to `buf`.
        from repro_torch.nocsim.credit import build_credit_program, run_credit

        cfg_schedules = [d.schedule for d in schedules]
        inc_pre = [d.route_inc_pre for d in schedules]
        inc_post = [d.schedule.route_inc / d.gamma[:, None] for d in schedules]
        prog_pre = build_credit_program(
            cfg_schedules, noc_params, inc_override=inc_pre, inj_override=inj
        )
        prog_post = build_credit_program(
            cfg_schedules, noc_params, inc_override=inc_post, inj_override=inj
        )
        if 0 < fail_w < w:
            p1 = dataclasses.replace(
                prog_pre, inj=inj[:fail_w], offered=prog_pre.offered[:fail_w]
            )
            p2 = dataclasses.replace(
                prog_post, inj=inj[fail_w:], offered=prog_post.offered[fail_w:]
            )
            tl1, (src, buf) = run_credit(p1, backend=backend, device=dev)
            buf = _apply_redistribution(buf, plans)
            tl2, _ = run_credit(p2, backend=backend, carry=(src, buf), device=dev)
            serviced_tl = np.concatenate([tl1.serviced, tl2.serviced])
            backlog_tl = np.concatenate([tl1.eff_backlog, tl2.eff_backlog])
        else:
            tl, _ = run_credit(
                prog_pre if fail_w == w else prog_post, backend=backend, device=dev
            )
            serviced_tl, backlog_tl = tl.serviced, tl.eff_backlog
    else:
        # `put`/`get` move the program and the carry to the stepper's device
        # and back: the carry crosses once each way at the failure window.
        step = open_step(backend)
        if dev is None:
            put = get = lambda a: a  # noqa: E731
        else:
            put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            get = lambda t: t.cpu().numpy()  # noqa: E731
        if 0 < fail_w < w:
            (s1, b1), carry = run_windows(step, (put(inj[:fail_w]),), None)
            carry = put(_apply_redistribution(get(carry), plans))
            (s2, b2), _ = run_windows(step, (put(inj[fail_w:]),), carry)
            serviced_tl = np.concatenate([get(s1), get(s2)])
            backlog_tl = np.concatenate([get(b1), get(b2)])
        else:
            (serviced_tl, backlog_tl), _ = run_windows(step, (put(inj),), None)
            serviced_tl, backlog_tl = get(serviced_tl), get(backlog_tl)
    results = []
    for c, ds in enumerate(schedules):
        sch = ds.schedule
        l = sch.inj.shape[1]
        cap = sch.cap_bytes
        results.append(
            assemble_result(
                sch,
                serviced_tl[:, c, :l] * cap,
                backlog_tl[:, c, :l] * cap,
                noc_params=noc_params,
                params=params,
                num_iterations=int(iters[c]),
                backend=backend,
            )
        )
    return results
