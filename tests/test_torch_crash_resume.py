"""Crash safety of the port's journaled faults runner through its CLI
(`repro_torch.experiments.run`, on the CPU): a run killed with SIGKILL
mid-sweep and resumed with `--resume` writes a byte-identical `minifaults`
artifact to an uninterrupted run's, and SIGTERM unwinds through the
journal-flush path, exits 130 and prints the `--resume` hint.
`REPRO_FAULTS_UNIT_DELAY` holds each unit open after its journal flush, so
the signal lands between units."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRID = "minifaults"


def _cmd(workdir: str, extra: tuple[str, ...] = ()) -> list[str]:
    return [
        sys.executable, "-m", "repro_torch.experiments.run",
        "--grid", GRID,
        "--backend", "torch",
        "--device", "cpu",
        "--cache-dir", os.path.join(workdir, "cache"),  # shared: resume must not depend on it
        "--sweeps-dir", os.path.join(workdir, "sweeps"),
        "--journal", os.path.join(workdir, "journal.json"),
        *extra,
    ]


def _env(**over: str) -> dict[str, str]:
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS_UNIT_DELAY", None)
    env.update(over)
    return env


def _journal_units(path: str) -> int:
    if not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            return len(json.load(f).get("units", {}))
    except (json.JSONDecodeError, OSError):
        return 0  # mid-replace glimpse; the write itself is atomic


def _wait_for_first_unit(workdir: str, proc: subprocess.Popen, timeout: float = 120.0) -> int:
    journal = os.path.join(workdir, "journal.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        n = _journal_units(journal)
        if n >= 1:
            return n
        if proc.poll() is not None:
            out, err = proc.communicate()
            raise AssertionError(f"runner exited before journaling a unit:\n{out}\n{err}")
        time.sleep(0.05)
    raise AssertionError("no unit reached the journal in time")


@pytest.mark.slow
def test_sigkill_then_resume_is_bit_identical(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    subprocess.run(_cmd(a, ("-q",)), env=_env(), check=True, timeout=560)

    # Victim: each unit held open after its flush, then kill -9 — no handler
    # runs, only the units already flushed survive.
    proc = subprocess.Popen(_cmd(b), env=_env(REPRO_FAULTS_UNIT_DELAY="2.0"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        survived = _wait_for_first_unit(b, proc)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
    assert survived >= 1
    assert not os.path.exists(os.path.join(b, "sweeps", f"{GRID}.json"))

    subprocess.run(_cmd(b, ("--resume", "-q")), env=_env(), check=True, timeout=560)
    with open(os.path.join(a, "sweeps", f"{GRID}.json"), "rb") as f:
        ref = f.read()
    with open(os.path.join(b, "sweeps", f"{GRID}.json"), "rb") as f:
        resumed = f.read()
    payload = json.loads(ref)
    assert payload["faults"]["records"] and payload["backend"] == "numpy+torch"
    assert resumed == ref  # byte-identical, not merely equivalent


@pytest.mark.slow
def test_sigterm_flushes_journal_and_hints_resume(tmp_path):
    w = str(tmp_path / "w")
    proc = subprocess.Popen(_cmd(w), env=_env(REPRO_FAULTS_UNIT_DELAY="2.0"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _wait_for_first_unit(w, proc)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 130, f"stdout:\n{out}\nstderr:\n{err}"
    assert "--resume" in out and "flushed 1 journal(s)" in out
    assert _journal_units(os.path.join(w, "journal.json")) >= 1
