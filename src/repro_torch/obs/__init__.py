"""Observability layer: span tracing, metrics registry, NoC flight recorder.

See `repro_torch.obs.trace` for the clock/determinism contract,
`repro_torch.obs.metrics` for the comparable/non_comparable namespace split,
`repro_torch.obs.recorder` for the Perfetto counter-track capture of
per-window NoC state, `repro_torch.obs.validate` for the zero-dependency
check of obs output files against the committed `schemas/`, and
`repro_torch.obs.cost` for the op counter the kernels and the mesh count
themselves through (`launch.roofline` sets its totals against a device).
"""
from __future__ import annotations

import resource

from . import metrics
from .recorder import FlightRecorder
from .trace import (
    Span,
    Tracer,
    deterministic_clock_active,
    disable_tracing,
    enable_tracing,
    export_chrome_trace,
    get_tracer,
    now_ns,
    now_s,
    span,
    tracing_enabled,
)
from .validate import validate_file

__all__ = [
    "Span",
    "Tracer",
    "metrics",
    "FlightRecorder",
    "validate_file",
    "span",
    "now_ns",
    "now_s",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
    "deterministic_clock_active",
    "export_chrome_trace",
    "peak_rss_mb",
]


def peak_rss_mb() -> float:
    """Peak RSS of this process in MiB (ru_maxrss is KiB on Linux).

    Owned by obs because RSS is wall-clock-adjacent: it varies run to run,
    so it must only ever land in non-comparable payload fields.  Under the
    deterministic clock (`REPRO_OBS_DETERMINISTIC=1`) it returns 0.0 so
    those fields, too, become byte-stable for the identity tests.
    """
    if deterministic_clock_active():
        return 0.0
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
