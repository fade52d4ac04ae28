"""The NoC flight recorder and the schema validator of `repro_torch.obs`
against `repro.obs`, on the CPU: fed by the same sweep, the two recorders
hold the same tracks, counter events and heatmap; the exported trace and
heatmap validate against the committed `schemas/`; and recording on leaves
every `run_sweep` payload byte-identical to recording off (under the
deterministic clock, in fresh processes)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.experiments import GRIDS as JAX_GRIDS
from repro.experiments import run_sweep as jax_run_sweep
from repro.obs import FlightRecorder as JaxFlightRecorder
from repro.obs.validate import validate as jax_validate
from repro_torch import obs
from repro_torch.experiments import GRIDS, run_sweep
from repro_torch.nocsim import NocSimParams, contended_batch
from repro_torch.obs import FlightRecorder, validate_file
from repro_torch.obs.validate import validate

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE_SCHEMA = str(ROOT / "schemas" / "trace.schema.json")
METRICS_SCHEMA = str(ROOT / "schemas" / "metrics.schema.json")


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """minicredit through both packages with a recorder attached (the port's
    torch arm on the CPU, the reference's numpy arm)."""
    mine, theirs = FlightRecorder(max_windows=64), JaxFlightRecorder(max_windows=64)
    port = run_sweep(GRIDS["minicredit"], device="cpu", measure_serial=False, recorder=mine)
    ref = jax_run_sweep(JAX_GRIDS["minicredit"], backend="numpy", measure_serial=False, recorder=theirs)
    return port, ref, mine, theirs


def test_recorders_hold_the_same_tracks_and_events(recorded):
    _, _, mine, theirs = recorded
    assert mine.summary() == theirs.summary()
    assert len(mine.summary()["tracks"]) == 4  # 2 configs × 2 routing arms
    assert mine.dropped_windows == theirs.dropped_windows == 0
    assert mine.to_counter_events() == theirs.to_counter_events()
    assert mine.counter_events_json() == theirs.counter_events_json()
    assert mine.phase_heatmap() == theirs.phase_heatmap()


def test_exported_trace_and_heatmap_validate(recorded, tmp_path):
    _, _, mine, theirs = recorded
    tracer = obs.Tracer()  # no spans: the recorder's counter tracks alone
    path = str(tmp_path / "trace.json")
    tracer.export(path, extra_events=mine.counter_events_json())
    assert validate_file(path, TRACE_SCHEMA) == []
    payload = json.loads(pathlib.Path(path).read_text())
    counters = [e for e in payload["traceEvents"] if e["ph"] == "C"]
    assert counters and counters[0]["name"].startswith("link")
    heat = mine.write_heatmap(str(tmp_path / "sub" / "trace.heatmap.json"))
    assert heat == json.loads((tmp_path / "sub" / "trace.heatmap.json").read_text())
    assert heat == theirs.phase_heatmap()


def test_validator_agrees_with_the_reference_and_has_teeth(tmp_path):
    schema = json.loads(pathlib.Path(TRACE_SCHEMA).read_text())
    good = {"traceEvents": [{"name": "x", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 1}]}
    bad = {"traceEvents": {"not": "a list"}}
    for doc in (good, bad, {}):
        assert validate(doc, schema) == jax_validate(doc, schema)
    assert validate(bad, schema)
    small = {"type": "object", "required": ["ph"],
             "properties": {"ph": {"enum": ["X", "C"]}, "ts": {"type": "number", "minimum": 0}}}
    assert validate({"ph": "X", "ts": 1.0}, small) == []
    assert validate({"ph": "Z"}, small) and validate({"ph": "X", "ts": -1}, small) and validate({}, small)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    assert validate_file(str(path), TRACE_SCHEMA)
    from repro_torch.obs.validate import main

    assert main([str(path), "--schema", TRACE_SCHEMA]) == 1


def test_metrics_snapshot_of_a_contention_sweep_validates(recorded, tmp_path):
    port, _, _, _ = recorded
    from repro_torch.experiments.sweep import metrics_snapshot_for

    snap = metrics_snapshot_for(port)
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(snap))
    assert validate_file(str(path), METRICS_SCHEMA) == []


def test_recorder_is_invisible_to_params_and_results():
    rec = FlightRecorder()
    p_rec, p_plain = NocSimParams(record_timeline=rec), NocSimParams()
    assert p_rec == p_plain and dataclasses.asdict(p_rec) == dataclasses.asdict(p_plain)
    assert p_rec.recorder is rec and dataclasses.replace(p_rec, inj_rate=2.0).recorder is None
    from repro_torch.core import Mesh2D, Placement, TrafficMatrix

    rng = np.random.default_rng(0)
    m = (rng.random((16, 16)) < 0.4) * rng.integers(1, 2000, size=(16, 16)).astype(np.float64)
    np.fill_diagonal(m, 0.0)
    t = TrafficMatrix(num_parts=4, bytes_matrix=m, phase_bytes={})
    pl = Placement(Mesh2D(4, 4), rng.permutation(16), "test")
    for kw in (dict(), dict(flow_control="credit", buffer_depth=4.0)):
        on = contended_batch([t], [pl], noc_params=NocSimParams(record_timeline=rec, **kw),
                             backend="numpy", window_chunk=8)
        off = contended_batch([t], [pl], noc_params=NocSimParams(**kw), backend="numpy")
        assert on[0].to_dict() == off[0].to_dict()
    arms = sorted(tr["arm"] for tr in rec.summary()["tracks"])
    assert arms == ["dor", "dor+credit(d=4)"]
    # the torch arm never feeds the recorder: it records from the numpy reference only
    quiet = FlightRecorder()
    contended_batch([t], [pl], noc_params=NocSimParams(record_timeline=quiet), backend="torch", device="cpu")
    assert quiet.summary()["tracks"] == []


_SWEEP_TO_JSON = (
    "import json, sys\n"
    "from repro_torch.experiments import GRIDS, run_sweep\n"
    "from repro_torch.obs import FlightRecorder\n"
    "rec = FlightRecorder() if sys.argv[1] == 'on' else None\n"
    "res = run_sweep(GRIDS['minicredit'], device='cpu', measure_serial=False, recorder=rec)\n"
    "assert rec is None or rec.summary()['tracks']\n"
    "print(json.dumps(res.to_dict(), sort_keys=True))\n"
)


def test_recording_on_equals_recording_off_byte_for_byte():
    outs = []
    for mode in ("off", "on"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_OBS_DETERMINISTIC="1")
        done = subprocess.run([sys.executable, "-c", _SWEEP_TO_JSON, mode], capture_output=True,
                              text=True, timeout=300, env=env, cwd=str(ROOT))
        assert done.returncode == 0, done.stderr[-2000:]
        outs.append(done.stdout)
    assert outs[0] == outs[1]
    payload = json.loads(outs[0])
    assert payload["contention"]["records"] and payload["contention"]["backends"] == ["numpy", "torch"]
