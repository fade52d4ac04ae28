"""Window semantics of the contended NoC replay + the serial reference API.

The model replays one execution's aggregate traffic as per-window flit
injections and drains per-link occupancy queues:

  * Every flow (nonzero router-pair entry of the placed traffic matrix) is
    decomposed into the paper's §4 phase structure from its endpoint shard
    *structures*: Process = {ET→vProp, vProp→eProp}, Reduce = {eProp→vTemp,
    ET→vTemp}, Apply = {vTemp→vProp}.  Phases execute in order, so traffic
    in different phases cannot overlap on the wire — the hotspot-formation
    effect the aggregate analytic peak misses.
  * The injection horizon is the analytic serialization budget stretched by
    the offered rate: T_inj = t_serial / inj_rate, split into `windows`
    equal windows of `window_s` seconds.  A window's injected bytes arrive
    at every link of the flow's route within that window (per-hop transit is
    ~1 ns against µs-scale windows, so staging arrivals by hop would be
    noise; the per-hop latency is charged in the latency term instead).
  * Each link services at most cap = link_bandwidth × window_s bytes per
    window; the excess carries over as backlog (queueing).

Outputs per config:

  * contended serialization `t_drain_s` = Σ_w max_l serviced[w, l] / bw
    + max_l backlog_final[l] / bw — the windowed generalization of the
    analytic peak-link term.  For any *separable* injection (per-link loads
    scaled by one time profile — the `uniform` and `burst` profiles) this is
    EXACTLY the analytic term at every rate, because the aggregate-peak link
    attains the per-window max throughout; the phase-resolved profile makes
    it Σ_phase peak_phase / bw ≥ peak / bw, strictly larger whenever
    different phases peak on different links.
  * queueing delay: a byte arriving in window w at link l waits
    backlog[w, l] / bw; packet latency = hops × hop_latency + Σ_route waits;
    the byte-weighted mean and p99 over (flow, window) are reported.
  * contended T_network = max(t_sf, t_drain) + t_latency + mean queue delay,
    mirroring `core.simulator.simulate`'s analytic
    t_network = max(t_sf, t_serial) + t_latency.  In the uncongested limit
    (uniform profile, inj_rate → 0) queueing vanishes and the contended
    T_network equals the analytic one — the tested convergence contract.

Everything here is float64 numpy and backend-independent: `ConfigSchedule`
is the precomputed injection program both steppers consume, and
`assemble_result` turns either stepper's timelines into a `NocSimResult`.
The actual window recursion lives in `nocsim.batch` (numpy reference +
the stacked float64 torch program).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import Placement
from repro_torch.core.simulator import SimParams
from repro_torch.core.traffic import EPROP, ET, VPROP, VTEMP, TrafficMatrix
from repro_torch.nocsim.routes import RouteOperators, assign_adaptive2, route_operators

__all__ = [
    "PHASES",
    "NocSimParams",
    "NocSimResult",
    "ConfigSchedule",
    "build_schedule",
    "assemble_result",
    "normalize_buffer_depth",
    "simulate_contended",
]


def normalize_buffer_depth(depth: float | int | None) -> float:
    """THE audited coercion for credit-arm buffer depths — every place a
    depth becomes a float goes through here (`NocSimParams`, the sweep's
    depth axis, `credit.build_credit_program`), so the validation rules
    live once and the lint's dtype rule (RPL003) can whitelist exactly one
    code path.  `None` means "no buffering bound" and maps to +inf, which
    the credit stepper reproduces the open-loop arm with bit-identically
    (the tested convergence contract).  Rejects NaN and non-positive
    depths; accepts ints (grid axes) and returns a plain Python float."""
    if depth is None:
        return float("inf")
    d = float(depth)
    if d != d:  # NaN: the `> 0` check below would pass it through `not`
        raise ValueError("buffer_depth must not be NaN")
    if not d > 0:
        raise ValueError("buffer_depth must be > 0 (inf for unbounded)")
    return d

PHASES = ("process", "reduce", "apply")
_PHASE_PAIRS = {
    0: ((ET, VPROP), (VPROP, EPROP)),  # process
    1: ((EPROP, VTEMP), (ET, VTEMP)),  # reduce
    2: ((VTEMP, VPROP),),  # apply
}


@dataclasses.dataclass(frozen=True)
class NocSimParams:
    """Knobs of the windowed replay (see module docstring for semantics)."""

    windows: int = 32  # injection windows per replay
    profile: str = "phases"  # phases | uniform | burst
    routing: str = "dor"  # dor | adaptive2 (see nocsim.routes)
    inj_rate: float = 1.0  # offered rate as a fraction of link bandwidth
    burst_frac: float = 0.25  # burst profile: share of windows carrying bytes
    latency_q: float = 0.99  # tail quantile reported as p99_latency_s
    flow_control: str = "open"  # open | credit (see nocsim.credit)
    # Per-link buffer depth in units of one window's service (credit arm
    # only).  inf recovers the open-loop arm bit-for-bit (tested contract).
    buffer_depth: float = float("inf")
    # Opt-in flight recorder (`repro_torch.obs.FlightRecorder`).  An InitVar, not
    # a field: `dataclasses.asdict(params)` lands verbatim in byte-compared
    # sweep payloads, so the recorder must be invisible to serialization,
    # equality, and `replace()` (which drops it — recording passes construct
    # their params explicitly).  Stored as the non-field `recorder` attr.
    record_timeline: dataclasses.InitVar[object | None] = None

    def __post_init__(self, record_timeline):
        if self.windows < 1:
            raise ValueError("windows must be >= 1")
        if self.profile not in ("phases", "uniform", "burst"):
            raise ValueError(f"unknown profile {self.profile!r}")
        if self.routing not in ("dor", "adaptive2"):
            raise ValueError(f"unknown routing {self.routing!r}")
        if self.flow_control not in ("open", "credit"):
            raise ValueError(f"unknown flow_control {self.flow_control!r}")
        object.__setattr__(
            self, "buffer_depth", normalize_buffer_depth(self.buffer_depth)
        )
        if not (self.inj_rate > 0):
            raise ValueError("inj_rate must be > 0")
        if not (0.0 < self.burst_frac <= 1.0):
            raise ValueError("burst_frac must be in (0, 1]")
        if not (0.0 < self.latency_q <= 1.0):
            raise ValueError("latency_q must be in (0, 1]")
        object.__setattr__(self, "recorder", record_timeline)


@dataclasses.dataclass(frozen=True)
class NocSimResult:
    """Contended network metrics for one config (scalars json-serializable;
    the two timelines are numpy arrays and stay out of sweep payloads)."""

    t_network_contended_s: float
    t_drain_s: float  # contended serialization term
    t_serialization_s: float  # analytic peak/bw under the SAME routing arm
    contention_excess: float  # t_drain / t_serialization (>= 1 - fp tol)
    mean_queue_delay_s: float  # byte-weighted mean per-packet queueing
    p99_latency_s: float  # byte-weighted latency_q packet latency
    mean_latency_s: float
    peak_link_load_bytes: float
    peak_link_share: float  # peak link load / total link-traversal bytes
    peak_window_util: float  # max over (w, l) of serviced / cap
    mean_bottleneck_util: float  # mean over w of max_l serviced / cap
    backlogged_window_frac: float  # windows with any backlog / windows
    saturation_bytes_per_s: float  # accepted-throughput bound bw·total/peak
    window_s: float
    windows: int
    routing: str
    backend: str
    util_timeline: np.ndarray  # (W,) per-window bottleneck utilization
    link_peak_util: np.ndarray  # (L,) per-link max window utilization
    flow_control: str = "open"  # which stepper arm produced the timelines
    buffer_depth: float | None = None  # credit arm only (None ≡ open loop)

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            if f.name in ("util_timeline", "link_peak_util"):
                continue
            v = getattr(self, f.name)
            # inf (e.g. the zero-traffic saturation bound) would serialize
            # as the non-RFC-8259 token `Infinity`; store null instead.
            if isinstance(v, float) and not np.isfinite(v):
                v = None
            d[f.name] = v
        return d


@dataclasses.dataclass
class ConfigSchedule:
    """The backend-independent injection program for one config."""

    inj: np.ndarray  # (W, L) float64 bytes arriving per window per link
    cap_bytes: float  # per-link service per window
    window_s: float
    link_loads: np.ndarray  # (L,) aggregate per-link bytes (chosen routing)
    peak_load: float
    t_serial_s: float  # peak_load / bw (this routing arm)
    route_inc: np.ndarray  # (L, F) dense 0/1 route incidence of the flows
    flow_bytes: np.ndarray  # (F,)
    flow_hops: np.ndarray  # (F,)
    flow_phase: np.ndarray  # (F,) int in {0, 1, 2}
    window_share: np.ndarray  # (W, 3) share of a phase's bytes per window
    total_bytes: float
    t_sf_s: float  # per-engine NIC occupancy bound (as in simulate())
    avg_hops: float
    num_links: int


def phase_of_flows(traffic: TrafficMatrix, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    """Phase index per flow from the endpoint shard structures; pairs outside
    the five §4 flows (none are produced by `traffic_from_partition`) fall
    into Process so bytes are always conserved."""
    si = ii // traffic.num_parts
    sj = jj // traffic.num_parts
    phase = np.zeros(ii.size, dtype=np.int64)
    for ph, pairs in _PHASE_PAIRS.items():
        for a, b in pairs:
            phase[(si == a) & (sj == b)] = ph
    return phase


def _window_share(
    phase_bytes: np.ndarray, params: NocSimParams
) -> np.ndarray:
    """(W, 3) share of a phase-ph flow's bytes injected in window w.  Phases
    profile: contiguous blocks ∝ phase bytes (≥ 1 window per nonzero phase),
    uniform within the block; uniform/burst: one separable profile shared by
    all phases."""
    w = params.windows
    share = np.zeros((w, 3), dtype=np.float64)
    if params.profile == "uniform":
        share[:] = 1.0 / w
        return share
    if params.profile == "burst":
        bw_windows = max(1, int(round(params.burst_frac * w)))
        share[:bw_windows] = 1.0 / bw_windows
        return share
    # phases: allocate windows ∝ bytes, at least one per nonzero phase, in
    # phase order; the remainder (from flooring) goes to the largest phase.
    total = float(phase_bytes.sum())
    active = phase_bytes > 0
    if total <= 0 or w < int(active.sum()):
        share[:] = 1.0 / w  # degenerate: fall back to uniform
        return share
    alloc = np.zeros(3, dtype=np.int64)
    alloc[active] = 1
    rest = w - int(alloc.sum())
    frac = np.where(active, phase_bytes / total, 0.0)
    extra = np.floor(frac * rest).astype(np.int64)
    alloc += extra
    leftover = w - int(alloc.sum())
    if leftover:
        alloc[int(np.argmax(phase_bytes))] += leftover
    start = 0
    for ph in range(3):
        if alloc[ph]:
            share[start : start + alloc[ph], ph] = 1.0 / alloc[ph]
            start += alloc[ph]
    return share


def build_schedule(
    traffic: TrafficMatrix,
    placement: Placement,
    *,
    noc_params: NocSimParams = NocSimParams(),
    params: SimParams = SimParams(),
) -> ConfigSchedule:
    """Precompute one config's injection program (float64, shared verbatim by
    the numpy and torch steppers — backend parity starts here)."""
    ops = route_operators(placement.topology)
    if ops is None:
        raise ValueError(
            f"topology {placement.topology.name!r} has no exact routing model "
            "(route_links_ordered returned None); the windowed contention "
            "simulator needs per-link routes"
        )
    topo = placement.topology
    n = topo.num_nodes
    m = traffic.bytes_matrix
    ii, jj = np.nonzero(m)
    flow_bytes = m[ii, jj].astype(np.float64)
    s = placement.site
    flow_ids = s[ii] * n + s[jj]
    dist = topo.distance_matrix()
    flow_hops = dist[s[ii], s[jj]].astype(np.float64)
    flow_phase = phase_of_flows(traffic, ii, jj)

    # route incidence under the chosen arm (dense (L, F); F = nnz flows)
    nat_inc = np.asarray(ops.nat[:, flow_ids].todense())
    if noc_params.routing == "adaptive2":
        flat = np.zeros(n * n, dtype=np.float64)
        np.add.at(flat, flow_ids, flow_bytes)
        rev_mask_all = assign_adaptive2(ops, flat)  # (N·N,) True → reversed
        rev_f = rev_mask_all[flow_ids]
        rev_inc = np.asarray(ops.rev[:, flow_ids].todense())
        route_inc = np.where(rev_f[None, :], rev_inc, nat_inc)
    else:
        route_inc = nat_inc

    phase_bytes = np.zeros(3, dtype=np.float64)
    np.add.at(phase_bytes, flow_phase, flow_bytes)
    window_share = _window_share(phase_bytes, noc_params)

    # per-phase link loads → the (W, L) injection schedule
    phase_onehot = np.equal.outer(flow_phase, np.arange(3)).astype(np.float64)
    loads_ph = route_inc @ (flow_bytes[:, None] * phase_onehot)  # (L, 3)
    link_loads = loads_ph.sum(axis=1)
    inj = window_share @ loads_ph.T  # (W, L)

    peak_load = float(link_loads.max()) if link_loads.size else 0.0
    bw = params.link_bandwidth_bytes_per_s
    t_serial = peak_load / bw
    horizon = t_serial / noc_params.inj_rate
    window_s = horizon / noc_params.windows
    # One division, NOT bw · window_s: the roundtrip through seconds costs an
    # ulp that can push the peak link's normalised injection past 1.0 and
    # fabricate queueing in exactly-saturated uniform replays.
    cap = peak_load / (noc_params.windows * noc_params.inj_rate)

    total_bytes = float(flow_bytes.sum())
    total_packets = total_bytes / params.packet_bytes
    per_engine_packets = total_packets / max(1, traffic.num_parts)
    byte_hops = float((flow_bytes * flow_hops).sum())
    avg_hops = byte_hops / total_bytes if total_bytes else 0.0
    t_sf = per_engine_packets * avg_hops * params.hop_latency_s
    return ConfigSchedule(
        inj=inj,
        cap_bytes=cap,
        window_s=window_s,
        link_loads=link_loads,
        peak_load=peak_load,
        t_serial_s=t_serial,
        route_inc=route_inc,
        flow_bytes=flow_bytes,
        flow_hops=flow_hops,
        flow_phase=flow_phase,
        window_share=window_share,
        total_bytes=total_bytes,
        t_sf_s=t_sf,
        avg_hops=avg_hops,
        num_links=ops.num_links,
    )


def _weighted_quantile(values: np.ndarray, weights: np.ndarray, q: float) -> float:
    """Smallest v with cumulative weight ≥ q of the total (0 if no weight)."""
    total = float(weights.sum())
    if total <= 0:
        return 0.0
    order = np.argsort(values, kind="stable")
    cum = np.cumsum(weights[order])
    idx = int(np.searchsorted(cum, q * total, side="left"))
    return float(values[order[min(idx, values.size - 1)]])


def assemble_result(
    schedule: ConfigSchedule,
    serviced: np.ndarray,  # (W, L) bytes serviced per window (stepper output)
    backlog: np.ndarray,  # (W, L) backlog after each window's service
    *,
    noc_params: NocSimParams,
    params: SimParams,
    num_iterations: int = 1,
    backend: str = "numpy",
) -> NocSimResult:
    """Shared float64 post-processing: timelines → metrics.  Both backends
    feed their own timelines through this, so any backend disagreement is
    attributable to the window recursion alone."""
    bw = params.link_bandwidth_bytes_per_s
    cap = schedule.cap_bytes
    w = noc_params.windows
    # Credit arm provenance on the record: buffer_depth reported only when
    # the closed-loop stepper ran (inf serializes as null via to_dict).
    flow_control = noc_params.flow_control
    buffer_depth = noc_params.buffer_depth if flow_control == "credit" else None
    if schedule.peak_load <= 0.0 or cap <= 0.0:
        zeros_w = np.zeros(w)
        t_latency = num_iterations * schedule.avg_hops * params.hop_latency_s
        return NocSimResult(
            t_network_contended_s=max(schedule.t_sf_s, 0.0) + t_latency,
            t_drain_s=0.0,
            t_serialization_s=0.0,
            contention_excess=1.0,
            mean_queue_delay_s=0.0,
            p99_latency_s=0.0,
            mean_latency_s=0.0,
            peak_link_load_bytes=0.0,
            peak_link_share=0.0,
            peak_window_util=0.0,
            mean_bottleneck_util=0.0,
            backlogged_window_frac=0.0,
            saturation_bytes_per_s=float("inf"),
            window_s=schedule.window_s,
            windows=w,
            routing=noc_params.routing,
            backend=backend,
            util_timeline=zeros_w,
            link_peak_util=np.zeros(schedule.link_loads.shape),
            flow_control=flow_control,
            buffer_depth=buffer_depth,
        )
    serviced = np.asarray(serviced, dtype=np.float64)
    backlog = np.asarray(backlog, dtype=np.float64)
    per_window_peak = serviced.max(axis=1)  # (W,)
    residual = float(backlog[-1].max())
    t_drain = (float(per_window_peak.sum()) + residual) / bw

    # queueing: a byte of window w waits backlog[w, l]/bw at each route link
    delay = backlog / bw  # (W, L)
    qdsum = delay @ schedule.route_inc  # (W, F): per-flow route wait per window
    weight = (
        schedule.window_share[:, schedule.flow_phase] * schedule.flow_bytes[None, :]
    )  # (W, F) injected bytes
    total_weight = float(weight.sum())
    latency = (
        schedule.flow_hops[None, :] * params.hop_latency_s + qdsum
    )  # (W, F) per-packet
    mean_queue = float((weight * qdsum).sum() / total_weight) if total_weight else 0.0
    mean_latency = float((weight * latency).sum() / total_weight) if total_weight else 0.0
    p99 = _weighted_quantile(latency.ravel(), weight.ravel(), noc_params.latency_q)

    t_latency = num_iterations * schedule.avg_hops * params.hop_latency_s
    t_contended = max(schedule.t_sf_s, t_drain) + t_latency + mean_queue
    total_link_bytes = float(schedule.link_loads.sum())
    link_peak_util = serviced.max(axis=0) / cap
    return NocSimResult(
        t_network_contended_s=t_contended,
        t_drain_s=t_drain,
        t_serialization_s=schedule.t_serial_s,
        contention_excess=t_drain / schedule.t_serial_s,
        mean_queue_delay_s=mean_queue,
        p99_latency_s=p99,
        mean_latency_s=mean_latency,
        peak_link_load_bytes=schedule.peak_load,
        peak_link_share=schedule.peak_load / total_link_bytes if total_link_bytes else 0.0,
        peak_window_util=float(serviced.max()) / cap,
        mean_bottleneck_util=float(per_window_peak.mean()) / cap,
        backlogged_window_frac=float((backlog.max(axis=1) > 1e-9 * cap).mean()),
        saturation_bytes_per_s=bw * schedule.total_bytes / schedule.peak_load,
        window_s=schedule.window_s,
        windows=w,
        routing=noc_params.routing,
        backend=backend,
        util_timeline=per_window_peak / cap,
        link_peak_util=link_peak_util,
        flow_control=flow_control,
        buffer_depth=buffer_depth,
    )


def simulate_contended(
    traffic: TrafficMatrix,
    placement: Placement,
    *,
    noc_params: NocSimParams = NocSimParams(),
    params: SimParams = SimParams(),
    num_iterations: int = 1,
    backend: str = "numpy",
    device=None,
) -> NocSimResult:
    """One config through the windowed contention simulator (the serial API
    `core.simulator.simulate(contention=...)` consumes; a thin wrapper over
    the batched stepper so serial and batched semantics are one code path).
    The torch arm runs on `device` (`None` is the CUDA device)."""
    from repro_torch.nocsim.batch import contended_batch

    (res,) = contended_batch(
        [traffic],
        [placement],
        noc_params=noc_params,
        params=params,
        num_iterations=num_iterations,
        backend=backend,
        device=device,
    )
    return res
