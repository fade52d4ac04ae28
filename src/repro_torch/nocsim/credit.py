"""Closed-loop credit/backpressure arm of the windowed NoC stepper.

The open-loop arm (`nocsim.batch`) lets every link absorb whatever its
routes inject — per-link independent queues, no downstream state gating
upstream arrivals — so it cannot form tree saturation or head-of-line
blocking.  This arm closes the loop with credit-based flow control:

  * every link has a finite buffer of `buffer_depth` normalised units
    (1 unit ≡ one window of full-bandwidth service, the same cap ≡ 1
    normalisation the open stepper runs in);
  * a flow may inject a window's bytes only while EVERY link on its route
    has credits (buffer headroom).  The admitted fraction of a flow's
    pending bytes is min over its route links of the link's
    headroom/demand ratio — demand-proportional fair share, the fluid
    limit of per-flit round-robin arbitration among the flows competing
    for a link's credits;
  * bytes that are not admitted are held AT THE SOURCE (`src` state per
    flow), not silently absorbed per link: they re-bid next window
    together with that window's fresh offered bytes — upstream stalls
    propagate, which is exactly the tree-saturation mechanism;
  * credits freed by a window's service become visible the NEXT window
    (admission reads the buffer state left by the previous service), the
    one-window credit-return latency of a real credit loop.

Per window w, with state `src` (C, F) held-at-source and `buf` (C, L)
buffered-per-link, all in normalised units:

    demand      = src + offered[w]                        # (C, F)
    demand_link = inc @ demand                            # (C, L)
    ratio_l     = min(1, max(depth − buf, 0) / demand_link)   (1 if idle)
    gate_f      = min over route links of ratio_l         # (C, F)
    admitted    = demand · gate
    src'        = demand − admitted
    arrivals    = max(inj[w] + inc @ (admitted − offered[w]), 0)
    arrived     = buf + arrivals
    serviced    = min(arrived, 1)                         # same op as open
    buf'        = arrived − serviced
    eff_backlog = buf' + inc @ src'      # outstanding incl. at-source bytes

Two deliberate formulations:

  * `arrivals` is the OPEN-LOOP program `inj[w]` plus the incidence-mapped
    admission delta, not `inc @ admitted` recomputed from scratch.  With
    infinite credits the gate is exactly 1.0, the delta is exactly zero,
    and `arrivals == inj[w]` bit-for-bit — so the infinite-credit run
    reproduces the open-loop arm BIT-IDENTICALLY on the float64 numpy
    reference and on the float64 torch stepper alike,
    a non-vacuous convergence contract the invariant suite asserts on all
    four topologies.  Under finite depth the delta can cancel to a tiny
    negative by rounding; the max(·, 0) clamp keeps arrivals physical at
    the cost of ulp-level conservation error (the conservation property
    tests use a 1e-9 relative tolerance for exactly this reason).
  * the admitted mass entering a link is ≤ ratio_l · demand_link ≤
    headroom, so `buf ≤ depth` always (the capacity invariant the
    property suite checks): a link's occupancy can never exceed
    buffer_depth × cap bytes.

`eff_backlog` (not the raw `buf`) is what `assemble_result` consumes as
the backlog timeline: the drain residual and the queueing delays then
account for bytes still held at sources, so T_network cannot improve by
merely refusing to inject.

Backends follow the repo's parity discipline: a float64 numpy reference
(windows loop in Python, configs vectorized, the flow-axis min taken with
`np.minimum.at` over precomputed (config, link, flow) route pairs) and the
same recursion as float64 tensors on a device (`_credit_step_torch`: the
three contractions as `bmm`, the min taken with `scatter_reduce_("amin")`
over the same pairs — min-reductions are order-exact, so the two backends
disagree only through the summation order of the contractions, ~1e-12
relative, gated ≤ 1e-9 in the tests and ≤ 1e-6 per sweep).  Both run under
`nocsim.batch.run_windows`, the ONE window-chunk carry runner shared with
the open and degraded arms, so `window_chunk=` cannot diverge between arms
(chunk-boundary regression-tested at sizes 1, W−1, W).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_backend, resolve_device
from repro_torch.nocsim.batch import run_windows, stacked_open_program
from repro_torch.nocsim.model import ConfigSchedule, NocSimParams, normalize_buffer_depth

__all__ = [
    "CreditProgram",
    "CreditTimelines",
    "build_credit_program",
    "run_credit",
]


@dataclasses.dataclass
class CreditProgram:
    """Stacked, normalised (cap ≡ 1) inputs of the credit recursion for one
    batch of configs, padded along the link and flow axes."""

    inj: np.ndarray  # (W, C, L) the open-loop injection program
    offered: np.ndarray  # (W, C, F) per-flow offered bytes per window
    inc: np.ndarray  # (C, L, F) route incidence (0/1; 1/γ on derated links)
    pair_c: np.ndarray  # (P,) int32 config index of each route pair
    pair_l: np.ndarray  # (P,) int32 link index of each route pair
    pair_f: np.ndarray  # (P,) int32 flow index of each route pair
    depth: float  # per-link buffer depth, normalised units (inf ok)

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.inj.shape

    def init_carry(self) -> tuple[np.ndarray, np.ndarray]:
        """Fresh (src, buf) state: nothing held, all credits available."""
        w, c, l = self.inj.shape
        f = self.offered.shape[2]
        return (
            np.zeros((c, f), dtype=np.float64),
            np.zeros((c, l), dtype=np.float64),
        )


@dataclasses.dataclass
class CreditTimelines:
    """Raw per-window state timelines (normalised units) — everything the
    conservation/capacity property tests need, beyond the two timelines
    `assemble_result` consumes."""

    serviced: np.ndarray  # (W, C, L)
    eff_backlog: np.ndarray  # (W, C, L) buf + inc @ src
    buf: np.ndarray  # (W, C, L) per-link buffer occupancy after service
    src: np.ndarray  # (W, C, F) held-at-source per flow after admission
    admitted: np.ndarray  # (W, C, F) admitted this window
    arrivals: np.ndarray  # (W, C, L) bytes entering each link buffer


def build_credit_program(
    schedules: list[ConfigSchedule],
    noc_params: NocSimParams,
    *,
    inc_override: list[np.ndarray] | None = None,
    inj_override: np.ndarray | None = None,
) -> CreditProgram:
    """Stack one batch of configs into the credit recursion's inputs.

    `inj` must be byte-for-byte the open-loop program (schedule.inj /
    cap_bytes) — the infinite-credit bit-identity contract starts here.
    `offered` is the same bytes resolved per flow instead of per link:
    offered[w, f] = window_share[w, phase(f)] · flow_bytes[f] / cap.
    The degraded arm passes `inc_override` (γ-scaled post-fault incidence)
    and `inj_override` (its two-segment program) to run the same recursion
    on a degraded fabric segment."""
    w = noc_params.windows
    n_cfg = len(schedules)
    l_max = max(s.inj.shape[1] for s in schedules)
    f_max = max(s.flow_bytes.size for s in schedules) if schedules else 0
    f_max = max(f_max, 1)  # keep the flow axis non-degenerate
    inj = stacked_open_program(schedules, w) if inj_override is None else inj_override
    offered = np.zeros((w, n_cfg, f_max), dtype=np.float64)
    inc = np.zeros((n_cfg, l_max, f_max), dtype=np.float64)
    pc, pl, pf = [], [], []
    for c, s in enumerate(schedules):
        nf = s.flow_bytes.size
        if s.cap_bytes <= 0.0 or nf == 0:
            continue
        offered[:, c, :nf] = (
            s.window_share[:, s.flow_phase] * s.flow_bytes[None, :] / s.cap_bytes
        )
        route_inc = s.route_inc if inc_override is None else inc_override[c]
        inc[c, : route_inc.shape[0], :nf] = route_inc
        ll, ff = np.nonzero(route_inc)
        pc.append(np.full(ll.size, c, dtype=np.int32))
        pl.append(ll.astype(np.int32))
        pf.append(ff.astype(np.int32))
    cat = lambda parts: (  # noqa: E731 - tiny local helper
        np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)
    )
    return CreditProgram(
        inj=inj,
        offered=offered,
        inc=inc,
        pair_c=cat(pc),
        pair_l=cat(pl),
        pair_f=cat(pf),
        depth=normalize_buffer_depth(noc_params.buffer_depth),
    )


def _credit_step_numpy(program: CreditProgram):
    """Reference recursion (float64; windows loop in Python, configs and
    links/flows vectorized).  Conforms to the `run_windows` step protocol:
    step(xs, carry) -> (timelines, carry)."""
    inc = program.inc
    depth = program.depth

    def step(xs, carry):
        inj, offered = xs
        src, buf = (
            program.init_carry() if carry is None else (carry[0].copy(), carry[1].copy())
        )
        w = inj.shape[0]
        serviced_tl = np.empty_like(inj)
        eff_tl = np.empty_like(inj)
        buf_tl = np.empty_like(inj)
        arr_tl = np.empty_like(inj)
        src_tl = np.empty_like(offered)
        adm_tl = np.empty_like(offered)
        gate = np.empty(offered.shape[1:], dtype=np.float64)
        for s in range(w):
            demand = src + offered[s]
            demand_link = np.einsum("clf,cf->cl", inc, demand)
            head = np.maximum(depth - buf, 0.0)
            pos = demand_link > 0.0
            ratio = np.where(
                pos,
                np.minimum(1.0, head / np.where(pos, demand_link, 1.0)),
                1.0,
            )
            gate.fill(1.0)
            np.minimum.at(
                gate,
                (program.pair_c, program.pair_f),
                ratio[program.pair_c, program.pair_l],
            )
            admitted = demand * gate
            src = demand - admitted
            arrivals = np.maximum(
                inj[s] + np.einsum("clf,cf->cl", inc, admitted - offered[s]), 0.0
            )
            arrived = buf + arrivals
            serviced = np.minimum(arrived, 1.0)
            buf = arrived - serviced
            serviced_tl[s] = serviced
            buf_tl[s] = buf
            arr_tl[s] = arrivals
            eff_tl[s] = buf + np.einsum("clf,cf->cl", inc, src)
            src_tl[s] = src
            adm_tl[s] = admitted
        return (serviced_tl, eff_tl, buf_tl, src_tl, adm_tl, arr_tl), (src, buf)

    return step


def _contract(inc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("clf,cf->cl", inc, v) as one batched matrix-vector product."""
    return torch.bmm(inc, v.unsqueeze(2)).squeeze(2)


def _credit_step_torch(program: CreditProgram, device: torch.device):
    """`_credit_step_numpy` as float64 tensors on `device`: the program's
    constants (incidence, flattened pair indices) are copied there once, the
    (src, buf) carry and the timelines stay there, and nothing is read back
    to the host inside the window loop.  Each window writes straight into its
    row of the preallocated timelines.  The flow-axis min is
    `scatter_reduce_("amin", include_self=True)` into a gate prefilled with
    1, the counterpart of `np.minimum.at`: flows with no route pair keep 1."""
    n_cfg, n_link, n_flow = program.inc.shape
    inc = torch.from_numpy(program.inc).to(device)
    pair_c = program.pair_c.astype(np.int64)
    ratio_at = torch.from_numpy(pair_c * n_link + program.pair_l).to(device)
    gate_at = torch.from_numpy(pair_c * n_flow + program.pair_f).to(device)
    depth = program.depth

    def step(xs, carry):
        inj, offered = xs
        if carry is None:
            src = torch.zeros((n_cfg, n_flow), dtype=torch.float64, device=device)
            buf = torch.zeros((n_cfg, n_link), dtype=torch.float64, device=device)
        else:
            src, buf = carry
        serviced_tl = torch.empty_like(inj)
        eff_tl = torch.empty_like(inj)
        buf_tl = torch.empty_like(inj)
        arr_tl = torch.empty_like(inj)
        src_tl = torch.empty_like(offered)
        adm_tl = torch.empty_like(offered)
        gate = torch.empty(n_cfg * n_flow, dtype=torch.float64, device=device)
        for s in range(inj.shape[0]):
            demand = src + offered[s]
            demand_link = _contract(inc, demand)
            head = torch.clamp_min_(depth - buf, 0.0)
            pos = demand_link > 0.0
            ratio = torch.where(
                pos,
                torch.clamp_max_(head / torch.where(pos, demand_link, 1.0), 1.0),
                1.0,
            )
            gate.fill_(1.0).scatter_reduce_(
                0, gate_at, ratio.reshape(-1)[ratio_at], "amin", include_self=True
            )
            admitted = torch.mul(demand, gate.view(n_cfg, n_flow), out=adm_tl[s])
            src = torch.sub(demand, admitted, out=src_tl[s])
            arrivals = torch.add(
                inj[s], _contract(inc, admitted - offered[s]), out=arr_tl[s]
            ).clamp_min_(0.0)
            arrived = torch.add(buf, arrivals, out=buf_tl[s])
            torch.clamp_max(arrived, 1.0, out=serviced_tl[s])
            buf = arrived.sub_(serviced_tl[s])
            torch.add(buf, _contract(inc, src), out=eff_tl[s])
        return (serviced_tl, eff_tl, buf_tl, src_tl, adm_tl, arr_tl), (src, buf)

    return step


def run_credit(
    program: CreditProgram,
    *,
    backend: str = "numpy",
    window_chunk: int | None = None,
    carry: tuple[np.ndarray, np.ndarray] | None = None,
    device: str | torch.device | None = None,
) -> tuple[CreditTimelines, tuple[np.ndarray, np.ndarray]]:
    """Run the credit recursion over the whole program (optionally window-
    chunked through the shared carry runner); returns the state timelines
    and the final (src, buf) carry for segment composition, as float64 host
    arrays on every backend.  `backend="torch"` runs on `device` (`None` is
    the CUDA device and raises without one): the program and the carry go
    there once, and the timelines and the carry come back once."""
    backend = resolve_backend(backend)
    if backend == "numpy":
        tls, out = run_windows(
            _credit_step_numpy(program), (program.inj, program.offered), carry,
            window_chunk=window_chunk,
        )
        return CreditTimelines(*tls), out
    dev = resolve_device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    tls, out = run_windows(
        _credit_step_torch(program, dev),
        (to_dev(program.inj), to_dev(program.offered)),
        None if carry is None else tuple(to_dev(a) for a in carry),
        window_chunk=window_chunk,
    )
    return (
        CreditTimelines(*(t.cpu().numpy() for t in tls)),
        tuple(a.cpu().numpy() for a in out),
    )
