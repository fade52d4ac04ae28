"""Contention-aware windowed NoC simulation (paper §6 evaluation gap).

The analytic simulator (`core.simulator`) charges the network one
serialization term — peak aggregate link load over link bandwidth — which is
blind to *when* bytes hit a link: time-multiplexed hotspots (the Process /
Reduce phase structure of §4), queue build-up, and routing-policy effects
are invisible.  This subsystem replays a `TrafficMatrix` as per-window flit
injections over the exact `Topology.route_links` paths and advances
per-link occupancy queues in discrete windows, producing a contended
T_network, per-link utilization timelines, saturation throughput, and tail
(p99) packet latency per config.

Layering: `nocsim` sits between `core` and `experiments` — it imports only
`core` (plus numpy/scipy/torch), and `experiments.sweep` drives it for the
`--grid contention` sweep.  `core.simulator.simulate` hooks into it lazily
(the optional `contention=` argument) to avoid an import cycle.

Modules: `routes` (dense route operators + the minimal-adaptive two-choice
assignment), `model` (window semantics, phase decomposition, the serial
numpy reference `simulate_contended`), `batch` (the stacked backends — a
vectorized float64 numpy reference stepper and the same recursion as
float64 torch tensors on a device, all sweep configs in one program; plus
`run_windows`, the window-chunk carry runner every arm shares), `credit`
(the closed-loop credit/backpressure arm: finite per-link buffers,
source-held backlog, admission gated on downstream credits;
`buffer_depth=inf` reproduces the open-loop arm bit-for-bit on both
backends — the tested convergence contract).
"""
from repro_torch.nocsim.model import NocSimParams, NocSimResult, simulate_contended
from repro_torch.nocsim.batch import (
    contended_batch,
    contention_sweep_payload,
    open_step,
    run_windows,
)
from repro_torch.nocsim.credit import (
    CreditProgram,
    CreditTimelines,
    build_credit_program,
    run_credit,
)
from repro_torch.nocsim.routes import (
    ROUTING_POLICIES,
    RouteOperators,
    assign_adaptive2,
    route_operators,
)

__all__ = [
    "NocSimParams",
    "NocSimResult",
    "simulate_contended",
    "contended_batch",
    "contention_sweep_payload",
    "open_step",
    "run_windows",
    "CreditProgram",
    "CreditTimelines",
    "build_credit_program",
    "run_credit",
    "ROUTING_POLICIES",
    "RouteOperators",
    "route_operators",
    "assign_adaptive2",
]
