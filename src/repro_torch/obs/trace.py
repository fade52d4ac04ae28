"""Zero-dependency span tracer with a Chrome-trace-event/Perfetto exporter.

One timing idiom for the whole tree: every duration measured anywhere in
`src/` comes off THIS module's clock (`now_s`/`now_ns`, or a `span()`
context manager around the timed region) — the lint's RPL009 rule bans raw
`time.perf_counter`-family calls outside `repro/obs/`, so the clock has one
owner and one switch.

Clock semantics:

  * Default: `time.monotonic_ns` — monotone, immune to wall-clock steps.
  * `REPRO_OBS_DETERMINISTIC=1`: a process-global counter advancing one
    fixed quantum per read.  Every duration in the process then depends
    only on the NUMBER of intervening clock reads, which is a pure
    function of the code path — so two runs over the same inputs produce
    byte-identical timing fields, which is what lets the recording-on ≡
    recording-off artifact byte-identity test compare whole files instead
    of masking "volatile" keys.  (`Span.__exit__` reads the clock whether
    or not tracing is enabled, so enabling tracing never changes the read
    count seen by payload code.)

Buffering and safety:

  * The buffer is per-process: `Tracer` remembers the pid it was created
    in and silently resets itself on first use after a `fork()`, so a
    subprocess never re-exports (or interleaves with) its parent's spans.
  * Appends take a lock and stamp `threading.get_ident()` — spans from
    concurrent threads land on separate Chrome-trace `tid` tracks.
  * When tracing is disabled (the default) `span()` still measures — its
    `duration_s` feeds the metrics/payload paths — but nothing is
    buffered, so the steady-state cost is two clock reads.

Export is the Chrome trace event format (`{"traceEvents": [...]}`,
timestamps/durations in microseconds), the JSON flavour `ui.perfetto.dev`
and `chrome://tracing` both load directly.  Wall-clock stays strictly out
of byte-compared artifacts (RPL005): trace/metrics files are observability
outputs, never sweep artifacts, and nothing here writes into payload dicts.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

__all__ = [
    "Span",
    "Tracer",
    "span",
    "now_ns",
    "now_s",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
    "deterministic_clock_active",
    "export_chrome_trace",
]

# One deterministic-clock quantum per read, in nanoseconds.  1 µs keeps
# Chrome-trace timestamps (µs floats) integral and human-scannable.
_DETERMINISTIC_QUANTUM_NS = 1_000

_DETERMINISTIC = os.environ.get("REPRO_OBS_DETERMINISTIC", "") == "1"
# itertools.count.__next__ is a single C call — atomic under the GIL, so
# concurrent threads never observe the same tick twice.
_FAKE_CLOCK = itertools.count(start=_DETERMINISTIC_QUANTUM_NS, step=_DETERMINISTIC_QUANTUM_NS)


def deterministic_clock_active() -> bool:
    """True when `REPRO_OBS_DETERMINISTIC=1` pinned the clock at import."""
    return _DETERMINISTIC


def now_ns() -> int:
    """THE tree-wide monotonic clock (see module docstring)."""
    if _DETERMINISTIC:
        return next(_FAKE_CLOCK)
    return time.monotonic_ns()  # repro-lint: disable=RPL009 the package's one clock read, exempt by the same rule as repro/obs/


def now_s() -> float:
    """`now_ns` in seconds — the drop-in for `time.perf_counter()` call
    sites that feed durations into payload dicts."""
    return now_ns() / 1e9


class Span:
    """One timed region.  Context-manager protocol; `duration_s` is valid
    after `__exit__` (and is measured whether or not tracing is enabled, so
    callers can feed it into timings dicts unconditionally).  `annotate()`
    attaches extra args visible in the exported trace."""

    __slots__ = ("name", "cat", "args", "pid", "tid", "start_ns", "dur_ns")

    def __init__(self, name: str, cat: str = "pipeline", **args):
        self.name = name
        self.cat = cat
        self.args = dict(args)
        self.pid = 0
        self.tid = 0
        self.start_ns = 0
        self.dur_ns = 0

    def __enter__(self) -> "Span":
        self.start_ns = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_ns = now_ns() - self.start_ns
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        tracer = _TRACER
        if tracer.enabled:
            self.pid = os.getpid()
            self.tid = threading.get_ident()
            tracer.add(self)
        return False

    def annotate(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    @property
    def duration_s(self) -> float:
        return self.dur_ns / 1e9


def span(name: str, cat: str = "pipeline", **args) -> Span:
    """`with span("sweep.trace", grid="mini") as sp: ...` — the one idiom."""
    return Span(name, cat, **args)


def _json_safe(value):
    """Span args may carry numpy scalars; coerce anything non-JSON to a
    plain float/str so export never raises mid-pipeline."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


class Tracer:
    """Per-process bounded span buffer + Chrome-trace exporter."""

    def __init__(self, max_spans: int = 100_000):
        self.max_spans = max_spans
        self.enabled = False
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._spans: list[Span] = []
        self.dropped_spans = 0

    def add(self, s: Span) -> None:
        with self._lock:
            if os.getpid() != self._pid:
                # First use after fork(): the child must not re-export the
                # parent's buffer — per-process buffers by construction.
                self._pid = os.getpid()
                self._spans = []
                self.dropped_spans = 0
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
                return
            self._spans.append(s)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped_spans = 0
            self._pid = os.getpid()

    def to_events(self) -> list[dict]:
        """Duration ('X') events plus process/thread metadata, sorted by
        (pid, tid, ts, -dur) so a parent span always precedes its children
        — export order is deterministic for any thread interleaving."""
        spans = sorted(
            self.spans(), key=lambda s: (s.pid, s.tid, s.start_ns, -s.dur_ns, s.name)
        )
        events: list[dict] = []
        seen_procs: set[int] = set()
        seen_threads: set[tuple[int, int]] = set()
        for s in spans:
            if s.pid not in seen_procs:
                seen_procs.add(s.pid)
                events.append(
                    {
                        "ph": "M", "name": "process_name", "pid": s.pid, "tid": 0,
                        "args": {"name": f"repro pipeline (pid {s.pid})"},
                    }
                )
            if (s.pid, s.tid) not in seen_threads:
                seen_threads.add((s.pid, s.tid))
                events.append(
                    {
                        "ph": "M", "name": "thread_name", "pid": s.pid, "tid": s.tid,
                        "args": {"name": f"thread {s.tid}"},
                    }
                )
            events.append(
                {
                    "ph": "X",
                    "name": s.name,
                    "cat": s.cat,
                    "ts": s.start_ns / 1e3,
                    "dur": max(s.dur_ns, 1) / 1e3,
                    "pid": s.pid,
                    "tid": s.tid,
                    "args": {k: _json_safe(v) for k, v in sorted(s.args.items())},
                }
            )
        return events

    def export(self, path: str, extra_events: list | tuple = ()) -> dict:
        """Write the Chrome-trace JSON: span events plus any caller-supplied
        events — dicts, or pre-serialized JSON object strings (the flight
        recorder's bulk fast path: serializing thousands of counter events
        through `json.dump` is what would push `--trace-out` overhead past
        the verify.sh 5%% gate).  One event per line keeps the file
        greppable.  Never silent about truncation: a clipped span buffer is
        recorded in `otherData.dropped_spans`.  Returns a small summary;
        read the file back for the full payload."""
        chunks = [json.dumps(e, separators=(",", ":")) for e in self.to_events()]
        for e in extra_events:
            chunks.append(e if isinstance(e, str) else json.dumps(e, separators=(",", ":")))
        other = {
            "producer": "repro_torch.obs",
            "deterministic_clock": deterministic_clock_active(),
            "dropped_spans": self.dropped_spans,
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write('{"traceEvents":[\n')
            fh.write(",\n".join(chunks))
            fh.write('\n],\n"displayTimeUnit":"ms",\n"otherData":')
            fh.write(json.dumps(other, separators=(",", ":")))
            fh.write("}\n")
        return {"path": path, "num_events": len(chunks), **other}


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable_tracing() -> Tracer:
    _TRACER.enabled = True
    return _TRACER


def disable_tracing() -> Tracer:
    _TRACER.enabled = False
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def export_chrome_trace(path: str, extra_events: list[dict] | tuple = ()) -> dict:
    """Module-level convenience over `get_tracer().export(...)`."""
    return _TRACER.export(path, extra_events=extra_events)
