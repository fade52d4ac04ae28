"""Crash-safe sweep journal: per-unit checkpoints behind `--resume`.

A `SweepJournal` is one JSON file recording every completed unit of a sweep
(keyed by the unit's deterministic id) plus a quarantine list of units that
errored or timed out.  Writes are atomic and durable — same-directory temp
file, `fsync`, `os.replace` — so a `kill -9` between units loses at most the
unit in flight; `--resume` reloads the journal and skips everything already
recorded, reproducing the uninterrupted run bit-identically (asserted by
tests/test_crash_resume.py) because every unit's payload is a pure function
of its config and seed (no wall-clock, no process state).

Journals live under `artifacts/journals/` by default — deliberately NOT the
sweeps directory, whose `*.json` files are all treated as renderable sweep
artifacts by `report.load_sweep_artifacts`.

Module-level registry: `run.py`'s SIGTERM/KeyboardInterrupt trap calls
`flush_all_journals()` so an interrupted sweep's partial journal always
reaches disk before the process exits.
"""
from __future__ import annotations

import json
import os
import signal
import weakref
from contextlib import contextmanager

__all__ = [
    "SweepJournal",
    "UnitTimeout",
    "flush_all_journals",
    "unit_timeout",
]

_OPEN_JOURNALS: "weakref.WeakSet[SweepJournal]" = weakref.WeakSet()


class UnitTimeout(Exception):
    """One unit exceeded its `--config-timeout` budget (SIGALRM)."""


@contextmanager
def unit_timeout(seconds: float):
    """Bound one unit's wall time via `signal.setitimer(ITIMER_REAL)`;
    raises `UnitTimeout` in the main thread when it expires.  `seconds <= 0`
    disables the bound (the default: resilience units are seconds-scale, the
    timeout exists to quarantine pathological configs, not to police normal
    ones)."""
    if seconds <= 0:
        yield
        return

    def _alarm(signum, frame):
        raise UnitTimeout(f"unit exceeded {seconds:g}s")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


class SweepJournal:
    """Per-unit checkpoint file for one sweep run.

    data layout (JSON):
      {"grid": <grid name>,
       "units": {unit_id: <unit record dict>},     # completed units
       "quarantine": {unit_id: {"error": str, "kind": str}}}
    """

    def __init__(self, path: str | os.PathLike, grid_name: str, *, resume: bool):
        self.path = os.fspath(path)
        self.grid_name = grid_name
        self.units: dict[str, dict] = {}
        self.quarantine: dict[str, dict] = {}
        if resume and os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            if data.get("grid") != grid_name:
                raise ValueError(
                    f"journal {self.path} belongs to grid {data.get('grid')!r},"
                    f" not {grid_name!r}"
                )
            self.units = dict(data.get("units", {}))
            # Quarantined units are retried on resume, not skipped: the
            # quarantine marks what failed LAST run, this run gets a fresh try.
            self.quarantine = {}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        _OPEN_JOURNALS.add(self)

    # ------------------------------------------------------------------ state
    def has(self, unit_id: str) -> bool:
        return unit_id in self.units

    def get(self, unit_id: str) -> dict:
        return self.units[unit_id]

    def record(self, unit_id: str, payload: dict) -> None:
        """Checkpoint one completed unit (flushes immediately: the journal on
        disk is always a prefix of the finished work)."""
        self.units[unit_id] = payload
        self.quarantine.pop(unit_id, None)
        self.flush()

    def quarantine_unit(self, unit_id: str, error: Exception) -> None:
        self.quarantine[unit_id] = {
            "error": str(error),
            "kind": type(error).__name__,
        }
        self.flush()

    # ------------------------------------------------------------------- disk
    def flush(self) -> None:
        """Atomic durable write: temp file in the journal's own directory
        (os.replace can't cross filesystems), fsync, replace."""
        data = {
            "grid": self.grid_name,
            "units": self.units,
            "quarantine": self.quarantine,
        }
        # No sort_keys: insertion order round-trips through json.load, so a
        # resumed run re-emits journaled records byte-identically.
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def close(self) -> None:
        self.flush()
        _OPEN_JOURNALS.discard(self)


def flush_all_journals() -> int:
    """Flush every open journal (the run.py signal-trap path); returns how
    many were flushed."""
    n = 0
    for j in list(_OPEN_JOURNALS):
        j.flush()
        n += 1
    return n
