"""NoC flight recorder: per-window per-link state as Perfetto counter tracks.

The steppers in `repro_torch.nocsim` already carry exactly the state the paper
reasons about — per-window link occupancy, backlog, credit headroom — and
then collapse it to scalars.  The recorder intercepts that state at chunk
boundaries (the `run_windows` `on_chunk` hook for the open-loop numpy
stepper; a post-hoc capture for the credit arm) and keeps a bounded ring
buffer per (config, arm) track.

Determinism contract (why the hook points are where they are):

  * RPL001 — never inside the stepper's window loop: capture only sees the
    numpy reference stepper and materialized timelines, the torch carry is
    untouched.
  * RPL005 — never into byte-compared artifacts: the recorder only READS
    normalized timelines the simulation already produced; its output goes
    to trace/heatmap files, and recording on vs off leaves every sweep
    artifact byte-identical (tested).

Ring-buffer truncation is never silent: each track counts the windows it
had to drop, the count is surfaced in `summary()`, stamped into the
Perfetto `process_labels` metadata, and printed by `run.py`.

Export shape: one Chrome-trace *process* per (config, arm) track, one
counter track per link (`ph: "C"`, name `link{NN}`), with `util` and
`backlog` series stacked per counter.  Timestamps are simulated time —
`window_index * window_s` in µs — so waves of head-of-line blocking line
up across links when opened in ui.perfetto.dev.
"""
from __future__ import annotations

import json
import os
from collections import deque

__all__ = ["FlightRecorder", "RECORDER_PID_BASE"]

# Counter tracks live in their own pid space, far above any real pid, so
# they render as separate processes from the span timeline.
RECORDER_PID_BASE = 1_000_000


class _Track:
    """Ring buffer of per-window samples for one (config, arm)."""

    __slots__ = ("key", "arm", "window_s", "num_links", "phases", "windows", "dropped")

    def __init__(self, key: str, arm: str, window_s: float, num_links: int, max_windows: int):
        self.key = key
        self.arm = arm
        self.window_s = window_s
        self.num_links = num_links
        self.phases: deque = deque(maxlen=max_windows)
        # each entry: (window_idx, util_row tuple, backlog_row tuple)
        self.windows: deque = deque(maxlen=max_windows)
        self.dropped = 0

    def append(self, window_idx: int, util_row, backlog_row, phase: str) -> None:
        if len(self.windows) == self.windows.maxlen:
            self.dropped += 1
        self.windows.append((window_idx, tuple(util_row), tuple(backlog_row)))
        self.phases.append(phase)


class FlightRecorder:
    """Opt-in per-window NoC state capture (see module docstring).

    `max_windows` bounds EACH track's ring buffer; older windows are
    evicted first and counted in `dropped_windows`.
    """

    def __init__(self, max_windows: int = 512):
        if max_windows < 1:
            raise ValueError("max_windows must be >= 1")
        self.max_windows = max_windows
        self._tracks: dict[tuple[str, str], _Track] = {}

    # -- capture ---------------------------------------------------------

    def capture_batch(self, schedules, serviced_norm, backlog_norm, *,
                      start_window: int = 0, arm: str = "open",
                      keys=None) -> None:
        """Record a chunk of normalized timelines.

        `schedules` is the list of `ConfigSchedule`s the batch ran (their
        `window_s`/`num_links`/`window_share` label the tracks; `keys`
        optionally names them — defaults to positional `config{c}`);
        `serviced_norm`/`backlog_norm` are `(W_chunk, C, L_max)` arrays in
        cap-normalized units (cap ≡ 1), exactly what the steppers carry.
        `start_window` is the absolute index of the chunk's first window.
        """
        from ..nocsim.model import PHASES

        n_windows = int(serviced_norm.shape[0])
        for c, sched in enumerate(schedules):
            key = keys[c] if keys is not None else f"config{c}"
            tkey = (key, arm)
            track = self._tracks.get(tkey)
            if track is None:
                track = _Track(key, arm, float(sched.window_s), int(sched.num_links),
                               self.max_windows)
                self._tracks[tkey] = track
            links = track.num_links
            share = getattr(sched, "window_share", None)
            for w in range(n_windows):
                abs_w = start_window + w
                if share is not None and abs_w < share.shape[0]:
                    phase = PHASES[int(share[abs_w].argmax())]
                else:
                    phase = PHASES[0]
                track.append(
                    abs_w,
                    [float(v) for v in serviced_norm[w, c, :links]],
                    [float(v) for v in backlog_norm[w, c, :links]],
                    phase,
                )

    # -- accounting ------------------------------------------------------

    @property
    def dropped_windows(self) -> int:
        return sum(t.dropped for _, t in sorted(self._tracks.items()))

    def summary(self) -> dict:
        """Per-track retained/dropped accounting — truncation is surfaced
        here (and in the Perfetto metadata), never swallowed."""
        tracks = []
        for (key, arm), t in sorted(self._tracks.items()):
            tracks.append(
                {
                    "key": key,
                    "arm": arm,
                    "num_links": t.num_links,
                    "windows_retained": len(t.windows),
                    "windows_dropped": t.dropped,
                }
            )
        return {
            "max_windows": self.max_windows,
            "tracks": tracks,
            "dropped_windows": self.dropped_windows,
        }

    # -- export ----------------------------------------------------------

    def to_counter_events(self, pid_base: int = RECORDER_PID_BASE) -> list[dict]:
        """Perfetto counter tracks: one process per (config, arm), one
        `ph: "C"` counter per link carrying `util` and `backlog` series."""
        events: list[dict] = []
        for i, ((key, arm), track) in enumerate(sorted(self._tracks.items())):
            pid = pid_base + i
            events.append(
                {
                    "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": f"noc {key} [{arm}]"},
                }
            )
            events.append(
                {
                    "ph": "M", "name": "process_labels", "pid": pid, "tid": 0,
                    "args": {
                        "labels": f"links={track.num_links}"
                                  f" retained={len(track.windows)}"
                                  f" dropped={track.dropped}"
                    },
                }
            )
            window_us = track.window_s * 1e6
            for (w, util_row, backlog_row) in track.windows:
                ts = w * window_us
                for link in range(track.num_links):
                    events.append(
                        {
                            "ph": "C",
                            "name": f"link{link:02d}",
                            "cat": "noc",
                            "ts": ts,
                            "pid": pid,
                            "tid": 0,
                            "args": {
                                "util": util_row[link],
                                "backlog": backlog_row[link],
                            },
                        }
                    )
        return events

    def counter_events_json(self, pid_base: int = RECORDER_PID_BASE) -> list[str]:
        """`to_counter_events` pre-serialized: the same events in the same
        order as JSON object strings, built with f-strings instead of
        `json.dumps` (≈10× faster over the thousands of counter events a
        recorded sweep produces — the difference between `--trace-out`
        passing and failing the verify.sh overhead gate).  Values are
        rendered with `%g`, so floats round-trip shorter but identically
        in kind; `tests/test_obs.py` asserts dict/json parity."""
        chunks: list[str] = []
        for i, ((key, arm), track) in enumerate(sorted(self._tracks.items())):
            pid = pid_base + i
            name = json.dumps(f"noc {key} [{arm}]")
            chunks.append(
                f'{{"ph":"M","name":"process_name","pid":{pid},"tid":0,'
                f'"args":{{"name":{name}}}}}'
            )
            labels = (
                f"links={track.num_links}"
                f" retained={len(track.windows)}"
                f" dropped={track.dropped}"
            )
            chunks.append(
                f'{{"ph":"M","name":"process_labels","pid":{pid},"tid":0,'
                f'"args":{{"labels":{json.dumps(labels)}}}}}'
            )
            window_us = track.window_s * 1e6
            links = range(track.num_links)
            # Hoist everything constant per (track, link) / per window out of
            # the hot per-event f-string — this loop renders thousands of
            # events and dominates the recorder's export cost.
            prefixes = [f'{{"ph":"C","name":"link{l:02d}","cat":"noc","ts":' for l in links]
            mid = f',"pid":{pid},"tid":0,"args":{{"util":'
            for (w, util_row, backlog_row) in track.windows:
                ts_mid = f"{w * window_us:g}{mid}"
                chunks.extend(
                    f'{prefixes[l]}{ts_mid}{util_row[l]:g},'
                    f'"backlog":{backlog_row[l]:g}}}}}'
                    for l in links
                )
        return chunks

    def phase_heatmap(self) -> dict:
        """Per-phase mean link utilization per track — the `process` /
        `reduce` / `apply` columns of the paper's phase structure, one row
        per link.  Windows evicted from the ring are (by definition) not
        averaged; `windows_dropped` travels alongside so the denominator
        is auditable."""
        from ..nocsim.model import PHASES

        out = {"version": 1, "max_windows": self.max_windows, "tracks": []}
        for (key, arm), track in sorted(self._tracks.items()):
            sums = {p: [0.0] * track.num_links for p in PHASES}
            counts = {p: 0 for p in PHASES}
            for (w, util_row, _backlog), phase in zip(track.windows, track.phases):
                counts[phase] += 1
                acc = sums[phase]
                for link in range(track.num_links):
                    acc[link] += util_row[link]
            heat = {}
            for p in PHASES:
                n = counts[p]
                heat[p] = [s / n for s in sums[p]] if n else []
            out["tracks"].append(
                {
                    "key": key,
                    "arm": arm,
                    "num_links": track.num_links,
                    "window_counts": {p: counts[p] for p in PHASES},
                    "mean_util": heat,
                    "windows_dropped": track.dropped,
                }
            )
        return out

    def write_heatmap(self, path: str) -> dict:
        heat = self.phase_heatmap()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(heat, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return heat
