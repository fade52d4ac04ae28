"""The windowed stepper, batched: numpy reference + one stacked torch program.

The window recursion per link is three elementwise ops —

    arrived  = backlog + injected
    serviced = min(arrived, cap)
    backlog  = arrived − serviced

— so the whole sweep stacks into (W, C, L_max) tensors: configs are padded
along the link axis to the largest link count in the batch (padded links
inject nothing and can never carry the per-window max), capacities are
normalised away per config (the recursion runs in units of one window's
service), and the torch backend advances ALL configs through one window per
step of a Python loop over the windows — no serial per-config loop:

  * numpy backend: float64, the reference semantics (windows loop in
    Python, configs vectorized);
  * torch backend: the same recursion in float64 on an explicit device,
    state and timelines kept there, the timelines copied to the host once a
    replay.  Add, min and sub round the same way in both, so the torch
    timelines equal the numpy ones bit for bit (tested, and checked on the
    card by `chip_smoke.py`); `contention_sweep_payload` still records the
    measured numpy↔torch max relative difference on the contended
    T_network against the 1e-6 contract.

Everything before the recursion (`build_schedule`) and after it
(`assemble_result`) is shared float64 numpy, so backend disagreement is
attributable to the window recursion alone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.registry import parity_pair_torch
from repro_torch.core.placement import Placement
from repro_torch.core.simulator import SimParams
from repro_torch.core.traffic import TrafficMatrix
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.nocsim.model import (
    ConfigSchedule,
    NocSimParams,
    NocSimResult,
    assemble_result,
    build_schedule,
    normalize_buffer_depth,
)
from repro_torch.nocsim.routes import ROUTING_POLICIES
from repro_torch.obs import span

__all__ = [
    "contended_batch",
    "contention_sweep_payload",
    "open_step",
    "run_windows",
    "PARITY_RTOL",
]

# Default window-chunk size when a caller asks for streaming without picking
# one: big enough to amortise dispatch, small enough to bound the stepper's
# working set.
DEFAULT_WINDOW_CHUNK = 64

# The numpy↔torch agreement contract on contended T_network, asserted per
# contention sweep.
PARITY_RTOL = 1e-6

def _step_numpy(
    inj: np.ndarray, backlog0: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Reference recursion: `inj` is (W, C, L) in units of one window's
    service (cap ≡ 1); returns (serviced, backlog) timelines of the same
    shape.  Windows advance in a Python loop; configs and links are
    vectorized.  `backlog0` carries the state across window chunks (the
    recursion is strictly sequential over windows, so resuming it from the
    previous chunk's final backlog reproduces the unchunked timelines
    bit-for-bit — on both backends)."""
    w = inj.shape[0]
    backlog = (
        np.zeros(inj.shape[1:], dtype=np.float64) if backlog0 is None else backlog0.copy()
    )
    serviced_tl = np.empty_like(inj)
    backlog_tl = np.empty_like(inj)
    for step in range(w):
        arrived = backlog + inj[step]
        serviced = np.minimum(arrived, 1.0)
        backlog = arrived - serviced
        serviced_tl[step] = serviced
        backlog_tl[step] = backlog
    return serviced_tl, backlog_tl


def _step_torch(
    inj: torch.Tensor, backlog0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """`_step_numpy` as float64 tensors on `inj`'s device: three launches a
    window, each writing straight into its row of the preallocated timelines
    (window w's backlog row is window w+1's carry); nothing is read back to
    the host inside the loop."""
    serviced_tl = torch.empty_like(inj)
    backlog_tl = torch.empty_like(inj)
    backlog = torch.zeros_like(inj[0]) if backlog0 is None else backlog0
    for step in range(inj.shape[0]):
        arrived = torch.add(backlog, inj[step], out=backlog_tl[step])
        torch.clamp_max(arrived, 1.0, out=serviced_tl[step])
        backlog = arrived.sub_(serviced_tl[step])
    return serviced_tl, backlog_tl


def _open_step_numpy(xs, carry):
    """`_step_numpy` in the `run_windows` step protocol (carry = backlog)."""
    s_tl, b_tl = _step_numpy(xs[0], carry)
    return (s_tl, b_tl), b_tl[-1]


def _open_step_torch(xs, carry):
    """`_step_torch` in the same protocol; the carry is a device tensor."""
    s_tl, b_tl = _step_torch(xs[0], carry)
    return (s_tl, b_tl), b_tl[-1]


def open_step(backend: str = "auto"):
    """The open-loop stepper for one backend, in `run_windows` protocol
    (`"auto"` is the torch stepper): the torch stepper takes and returns
    tensors on the device of its inputs."""
    return _open_step_torch if resolve_backend(backend) == "torch" else _open_step_numpy


def _alloc_windows(like, w: int):
    """An uninitialised (w, *like.shape[1:]) buffer of `like`'s kind: a numpy
    array, or a tensor on `like`'s device."""
    if isinstance(like, torch.Tensor):
        return like.new_empty((w, *like.shape[1:]))
    return np.empty((w, *like.shape[1:]), dtype=like.dtype)


def run_windows(step, xs: tuple, carry, *, window_chunk: int | None = None,
                on_chunk=None):
    """THE window-carry runner, shared by every stepper arm (open, credit,
    degraded segments): run `step` over the window axis in chunks of
    `window_chunk`, threading the arm's carry state between chunks.

    `step(xs_chunk, carry) -> (timelines, carry)` where `xs_chunk` is each
    input sliced along axis 0 and `timelines` is a tuple of window-axis
    arrays (numpy arrays, or tensors on one device for the torch arm — the
    carry then stays on that device between chunks); `carry=None` means the
    arm's fresh initial state.  Every recursion here is strictly sequential
    over windows, so the chunk boundary state equals the unchunked run's
    state at that window and the chunked timelines are bit-identical on both
    backends for ANY chunk size (regression-tested at the adversarial sizes
    1, W−1, W).  Chunks are written into timelines preallocated for all W
    windows.  Because the arms share this one code path, `window_chunk=`
    cannot diverge between them.  The stepper's working set is bounded at
    O(chunk · state).

    `on_chunk(start_window, timelines)` is the flight-recorder tap: invoked
    AFTER each chunk's recursion completes (once, at window 0, for the
    unchunked path) with the chunk's materialized timelines.  It observes
    outputs only — never the carry, never inside the window loop — so it
    cannot perturb the recursion and sees identical data with any chunk
    size."""
    w = xs[0].shape[0]
    if window_chunk is None:
        tls, carry = step(tuple(xs), carry)
        if on_chunk is not None:
            on_chunk(0, tls)
        return tls, carry
    chunk = max(1, int(window_chunk))
    out = None
    for start in range(0, w, chunk):
        tls, carry = step(tuple(x[start : start + chunk] for x in xs), carry)
        if on_chunk is not None:
            on_chunk(start, tls)
        if out is None:
            out = tuple(_alloc_windows(t, w) for t in tls)
        for o, t in zip(out, tls):
            o[start : start + t.shape[0]] = t
    return out, carry


def _host(a) -> np.ndarray:
    """A float64 host array of a stepper's timeline (one copy for a tensor)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


def stacked_open_program(schedules: list[ConfigSchedule], windows: int) -> np.ndarray:
    """The normalised (W, C, L_max) float64 open-loop injection program of a
    batch of schedules (cap ≡ 1, links padded with zeros) — built on the host
    for every backend, so the torch arm gets the numpy program's bytes."""
    l_max = max(s.inj.shape[1] for s in schedules)
    inj = np.zeros((windows, len(schedules), l_max), dtype=np.float64)
    for c, s in enumerate(schedules):
        if s.cap_bytes > 0.0:
            inj[:, c, : s.inj.shape[1]] = s.inj / s.cap_bytes
    return inj


@parity_pair_torch(
    serial="repro_torch.nocsim.model.simulate_contended",
    kind="rel",
    tol=1e-9,
    note="`simulate_contended` is a 1-config call into the same float64 numpy "
    "stepper (IS the reference); the torch open arm equals it bit for bit, the "
    "credit arm within 1e-9 relative (einsum order; tests/test_torch_nocsim.py)",
)
def contended_batch(
    traffics: list[TrafficMatrix],
    placements: list[Placement],
    *,
    noc_params: NocSimParams = NocSimParams(),
    params: SimParams = SimParams(),
    num_iterations: np.ndarray | list[int] | int = 1,
    backend: str = "auto",
    schedules: list[ConfigSchedule] | None = None,
    window_chunk: int | None = None,
    config_keys: list[str] | None = None,
    device: str | torch.device | None = None,
) -> list[NocSimResult]:
    """Batched contended simulation: one `NocSimResult` per (traffic,
    placement) pair, in input order.  All configs advance through one
    stacked recursion regardless of topology (the link axis is padded to
    the batch maximum).  `schedules` lets a caller running several backends
    over the same configs (the parity measurement) build them once.
    `window_chunk` streams the recursion over window chunks with the arm's
    carry state threaded between them — bit-identical to the unchunked run
    on both backends for any chunk size (see `run_windows`).  With
    `noc_params.flow_control == "credit"` the closed-loop stepper
    (`nocsim.credit`) runs instead of the open-loop recursion; its
    effective backlog (per-link buffer + at-source holdback mapped over the
    route) feeds the same `assemble_result` post-processing.

    `backend` is "numpy", "torch" or "auto" (= "torch"); the torch arm runs
    on `device` (`None` is the CUDA device and raises without one).

    When `noc_params` carries a flight recorder (constructed with
    `NocSimParams(record_timeline=...)`) and the numpy reference backend
    runs, the per-window normalized timelines stream into it: the open
    loop taps `run_windows`' `on_chunk` boundary, the credit arm captures
    its materialized timelines post-hoc — never the torch carry, never the
    window loop, and never the result values themselves, so recording on vs
    off returns bit-identical `NocSimResult`s (tested).  `config_keys` names
    the recorder tracks (defaults to positional)."""
    if len(traffics) != len(placements):
        raise ValueError("traffics and placements must pair up")
    n_cfg = len(traffics)
    if n_cfg == 0:
        return []
    iters = np.broadcast_to(np.asarray(num_iterations, dtype=np.int64), (n_cfg,))
    backend = resolve_backend(backend)
    dev = resolve_device(device) if backend == "torch" else None
    if schedules is None:
        schedules = [
            build_schedule(t, p, noc_params=noc_params, params=params)
            for t, p in zip(traffics, placements)
        ]
    recorder = getattr(noc_params, "recorder", None)
    if recorder is not None and backend != "numpy":
        recorder = None  # record from the float64 reference arm only
    if noc_params.flow_control == "credit":
        from repro_torch.nocsim.credit import build_credit_program, run_credit

        program = build_credit_program(schedules, noc_params)
        tl, _ = run_credit(program, backend=backend, window_chunk=window_chunk, device=dev)
        serviced_tl, backlog_tl = tl.serviced, tl.eff_backlog
        if recorder is not None:
            recorder.capture_batch(
                schedules,
                serviced_tl,
                backlog_tl,
                start_window=0,
                arm=f"{noc_params.routing}+credit(d={noc_params.buffer_depth:g})",
                keys=config_keys,
            )
    else:
        inj = stacked_open_program(schedules, noc_params.windows)
        on_chunk = None
        if recorder is not None:
            def on_chunk(start, tls, _scheds=schedules):
                recorder.capture_batch(
                    _scheds,
                    tls[0],
                    tls[1],
                    start_window=start,
                    arm=noc_params.routing,
                    keys=config_keys,
                )
        xs = (inj,) if dev is None else (torch.from_numpy(inj).to(dev),)
        serviced_tl, backlog_tl = map(_host, run_windows(
            open_step(backend), xs, None, window_chunk=window_chunk,
            on_chunk=on_chunk,
        )[0])
    results = []
    for c, s in enumerate(schedules):
        l = s.inj.shape[1]
        cap = s.cap_bytes
        results.append(
            assemble_result(
                s,
                serviced_tl[:, c, :l] * cap,
                backlog_tl[:, c, :l] * cap,
                noc_params=noc_params,
                params=params,
                num_iterations=int(iters[c]),
                backend=backend,
            )
        )
    return results


def contention_sweep_payload(
    configs: list,
    traffics: list[TrafficMatrix],
    placements: list[Placement],
    *,
    num_iterations: np.ndarray | list[int] | int = 1,
    params: SimParams = SimParams(),
    noc_params: NocSimParams = NocSimParams(),
    buffer_depths: tuple[float, ...] | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """The `--grid contention` sweep pass: every config × every routing arm
    through the windowed simulator, on BOTH backends — the float64 numpy
    reference and the torch stepper on `device` (`None` is the CUDA device
    and raises without one; there is no numpy-only fallback).

    Reported numbers come from the float64 numpy reference; the torch run
    exists to (a) measure the stacked program's wall time and (b) measure
    the backend parity `backend_parity_max_rel` = max over (config, arm) of
    the relative |numpy − torch| on the contended T_network, gated ≤
    `PARITY_RTOL`.  `configs` are `SweepConfig`-like objects (need `.key`
    plus the axis fields); records join back to sweep records on `key`.

    `buffer_depths` adds the closed-loop credit arm (`nocsim.credit`): per
    routing arm, one extra record set per depth (tagged
    `flow_control="credit"` / `buffer_depth`), folded into the same parity
    measurement — plus the infinite-credit convergence audit: a
    `buffer_depth=inf` credit run must reproduce the open-loop records
    bit-identically on numpy (`credit_inf_numpy_max_abs == 0.0`) and on
    torch (`credit_inf_torch_max_rel`, 0.0 there too, within the parity
    contract in any case).  The keys say `torch` where the reference
    package's payload says `jax`."""
    import dataclasses as _dc

    dev = resolve_device(device)
    n_cfg = len(traffics)
    iters = np.broadcast_to(np.asarray(num_iterations, dtype=np.int64), (n_cfg,))
    records: list[dict] = []
    parity_max = 0.0
    inf_np_max_abs = 0.0 if buffer_depths is not None else None
    inf_torch_max_rel = None
    timings: dict[str, float] = {}

    def run_arm(arm_params, schedules, tag):
        nonlocal parity_max
        runs = {}
        for backend in ("numpy", "torch"):
            with span(f"nocsim.{tag}.{backend}", cat="nocsim", configs=n_cfg) as sp:
                runs[backend] = contended_batch(
                    traffics,
                    placements,
                    noc_params=arm_params,
                    params=params,
                    num_iterations=iters,
                    backend=backend,
                    schedules=schedules,
                    device=dev,
                )
            timings[f"{tag}_{backend}_s"] = sp.duration_s
        ref, acc = runs["numpy"], runs["torch"]
        for r_np, r_t in zip(ref, acc):
            denom = max(abs(r_np.t_network_contended_s), 1e-300)
            parity_max = max(
                parity_max,
                abs(r_np.t_network_contended_s - r_t.t_network_contended_s) / denom,
            )
        return ref, acc

    for routing in ROUTING_POLICIES:
        arm_params = _dc.replace(noc_params, routing=routing)
        schedules = [
            build_schedule(t, p, noc_params=arm_params, params=params)
            for t, p in zip(traffics, placements)
        ]
        ref, acc = run_arm(arm_params, schedules, routing)
        for cfg, res in zip(configs, ref):
            records.append({"key": cfg.key, **_dc.asdict(cfg), **res.to_dict()})
        if buffer_depths is None:
            continue
        # Closed-loop credit arm: one record set per buffer depth (the
        # schedules are flow-control-independent and reused verbatim).
        for depth in buffer_depths:
            cr_params = _dc.replace(
                arm_params,
                flow_control="credit",
                buffer_depth=normalize_buffer_depth(depth),
            )
            cref, _ = run_arm(cr_params, schedules, f"{routing}_credit_d{depth:g}")
            for cfg, res in zip(configs, cref):
                records.append({"key": cfg.key, **_dc.asdict(cfg), **res.to_dict()})
        # Infinite-credit convergence audit vs the open-loop records above
        # (depth None ≡ unbounded buffering ≡ the open loop, bit-for-bit).
        inf_params = _dc.replace(
            arm_params,
            flow_control="credit",
            buffer_depth=normalize_buffer_depth(None),
        )
        iref, iacc = run_arm(inf_params, schedules, f"{routing}_credit_inf")
        for r_o, r_i in zip(ref, iref):
            inf_np_max_abs = max(
                inf_np_max_abs,
                abs(r_o.t_network_contended_s - r_i.t_network_contended_s),
                abs(r_o.t_drain_s - r_i.t_drain_s),
                abs(r_o.mean_queue_delay_s - r_i.mean_queue_delay_s),
            )
        inf_torch_max_rel = inf_torch_max_rel or 0.0
        for r_o, r_i in zip(acc, iacc):
            denom = max(abs(r_o.t_network_contended_s), 1e-300)
            inf_torch_max_rel = max(
                inf_torch_max_rel,
                abs(r_o.t_network_contended_s - r_i.t_network_contended_s) / denom,
            )
    return {
        "noc_params": _dc.asdict(noc_params),
        "records": records,
        "backends": ["numpy", "torch"],
        "backend_parity_max_rel": parity_max,
        "parity_rtol": PARITY_RTOL,
        "buffer_depths": list(buffer_depths) if buffer_depths is not None else None,
        "credit_inf_numpy_max_abs": inf_np_max_abs,
        "credit_inf_torch_max_rel": inf_torch_max_rel,
        "timings": timings,
    }
