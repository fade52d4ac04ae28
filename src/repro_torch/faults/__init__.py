"""Fault injection and graceful degradation for the NoC fabric.

Layering: `core` ← `nocsim` ← `faults` ← `experiments`.  This package owns
the fault model (`FaultSet`: dead/derated links and dead tiles with seeded,
connectivity-preserving samplers), detour-capable routing that never
traverses a dead link yet reduces bit-identically to the pristine
dimension-ordered routes when the fault set is empty, placement
evacuation/repair after tile deaths (bounded incremental best-move descent
seeded from the surviving layout), and the degraded windowed-NoC arm that
injects a mid-window link-failure event into both nocsim backends.

The experiments layer (`repro_torch.experiments.resilience`) drives these
pieces as the journaled `--grid faults` sweep.
"""
from repro_torch.faults.model import FaultSet, sample_link_faults, sample_tile_faults
from repro_torch.faults.routing import (
    degraded_distance_matrix,
    route_links_faulty,
    surviving_link_keys,
)
from repro_torch.faults.repair import RepairReport, evacuate_placement, repair_placement
from repro_torch.faults.degraded import (
    DegradedSchedule,
    build_degraded_schedule,
    degraded_batch,
)

__all__ = [
    "FaultSet",
    "sample_link_faults",
    "sample_tile_faults",
    "route_links_faulty",
    "degraded_distance_matrix",
    "surviving_link_keys",
    "RepairReport",
    "evacuate_placement",
    "repair_placement",
    "DegradedSchedule",
    "build_degraded_schedule",
    "degraded_batch",
]
