"""The port's sweep CLI (`repro_torch.experiments.run`) against the reference
package's (`repro.experiments.run`), on the CPU.

The exit test of the port's main path: `--grid mini|minicredit|minifaults
--backend torch --device cpu` gives the records of `--backend numpy` in the
reference — config keys, placements, simulator and contention scalars equal
(the float64 numpy path is the reference of record, and the golden tests hold
its scalars bit-exact); only wall times (`elapsed_us`, `timings`, the
placement stage's `search_s`/`construct_s`) and the second arm's name and
parity differ.  Beside it: `--check` on the port's outputs, the device rule,
default paths under `artifacts/torch/`, observability on ≡ off, and the torus
smoke of the reference's CLI test.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest
import torch

from repro.experiments.run import main as jax_run_main
from repro_torch.experiments import report
from repro_torch.experiments.run import main as run_main
from repro_torch.obs import metrics
from repro_torch.obs.validate import validate_file

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
FIXTURES = ROOT / "tests" / "fixtures"
TRACE_SCHEMA = str(ROOT / "schemas" / "trace.schema.json")
METRICS_SCHEMA = str(ROOT / "schemas" / "metrics.schema.json")

WALL_FIELDS = {"elapsed_us"}
PLACEMENT_WALL_FIELDS = {"search_s", "construct_s"}


def _argv(workdir: pathlib.Path, grid: str, *extra: str) -> list[str]:
    return [
        "--grid", grid,
        "--md", str(workdir / "EXP.md"),
        "--json", str(workdir / "BENCH.json"),
        "--sweeps-dir", str(workdir / "sweeps"),
        "--cache-dir", str(workdir / "cache"),
        "--journal", str(workdir / "journal.json"),
        "-q", *extra,
    ]


def _jax_main(argv: list[str]) -> int:
    """The reference CLI in process; it leaves its SIGTERM trap installed, so
    the caller's handler is put back."""
    previous = signal.getsignal(signal.SIGTERM)
    try:
        return jax_run_main(argv)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _payload(workdir: pathlib.Path, grid: str) -> dict:
    path = workdir / "sweeps" / f"{grid}.json" if grid == "minifaults" else workdir / "BENCH.json"
    return json.loads(path.read_text())


def _without(d: dict, fields) -> dict:
    return {k: v for k, v in d.items() if k not in fields}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mini grid once through both CLIs: {grid: (port payload, reference payload, port dir)}."""
    out = {}
    for grid in ("mini", "minicredit", "minifaults"):
        ref_dir = tmp_path_factory.mktemp(f"ref_{grid}")
        port_dir = tmp_path_factory.mktemp(f"port_{grid}")
        nodir = str(ref_dir / "nodir")
        assert _jax_main(_argv(ref_dir, grid, "--backend", "numpy",
                               "--dryrun-artifacts", nodir, "--perf-artifacts", nodir)) == 0
        assert run_main(_argv(port_dir, grid, "--backend", "torch", "--device", "cpu")) == 0
        out[grid] = (_payload(port_dir, grid), _payload(ref_dir, grid), port_dir)
    return out


@pytest.mark.parametrize("grid", ["mini", "minicredit"])
def test_sweep_records_match_the_reference(runs, grid):
    port, ref, _ = runs[grid]
    assert port["backend"] == "torch" and ref["backend"] == "numpy"
    assert port["grid"] == ref["grid"] and port["grid"]["name"] == grid
    assert [r["key"] for r in port["records"]] == [r["key"] for r in ref["records"]]
    for a, b in zip(port["records"], ref["records"]):
        assert _without(a, WALL_FIELDS) == _without(b, WALL_FIELDS), a["key"]
    assert [_without(c, WALL_FIELDS) for c in port["comparisons"]] == [
        _without(c, WALL_FIELDS) for c in ref["comparisons"]
    ]
    assert port["workload_stats"] == ref["workload_stats"]
    assert port["sim_params"] == ref["sim_params"]
    ps, rps = port["placement_stats"], ref["placement_stats"]
    assert ps["backend"] == "torch" and rps["backend"] == "numpy"
    assert _without(ps, PLACEMENT_WALL_FIELDS | {"backend"}) == _without(rps, PLACEMENT_WALL_FIELDS | {"backend"})
    if grid == "mini":
        assert port["contention"] is None and ref["contention"] is None
        return
    a, b = port["contention"], ref["contention"]
    assert a["records"] == b["records"] and len(a["records"]) == 12
    for key in ("noc_params", "buffer_depths", "parity_rtol", "credit_inf_numpy_max_abs"):
        assert a[key] == b[key], key
    assert a["credit_inf_numpy_max_abs"] == 0.0
    assert a["backends"] == ["numpy", "torch"]
    assert a["backend_parity_max_rel"] <= a["parity_rtol"]
    assert a["credit_inf_torch_max_rel"] <= a["parity_rtol"]


def test_faults_units_match_the_reference(runs):
    port, ref, _ = runs["minifaults"]
    assert port["grid"] == ref["grid"]
    assert port["backend"] == "numpy+torch" and ref["backend"] == "numpy"
    a, b = port["faults"], ref["faults"]
    assert [r["unit_id"] for r in a["records"]] == [r["unit_id"] for r in b["records"]]
    for x, y in zip(a["records"], b["records"]):
        assert y["backend_parity_rel"] is None and 0.0 <= x["backend_parity_rel"] <= a["parity_rtol"]
        assert _without(x, {"backend_parity_rel"}) == _without(y, {"backend_parity_rel"}), x["unit_id"]
    for key in ("repair", "quarantined", "parity_rtol", "fail_window", "noc_params"):
        assert a[key] == b[key], key
    assert a["quarantined"] == {} and len(a["repair"]) == 3
    assert a["backend_parity_max_rel"] <= a["parity_rtol"] and b["backend_parity_max_rel"] is None


def test_open_loop_records_equal_the_golden_contention_fixture(runs):
    """`minicredit`'s open-loop records are the frozen contention slice:
    every frozen field, bit for bit."""
    port, _, _ = runs["minicredit"]
    golden = json.loads((FIXTURES / "golden_contention_mesh2d.json").read_text())
    got = {(r["key"], r["routing"]): r for r in port["contention"]["records"] if r["flow_control"] == "open"}
    assert len(golden["records"]) == len(got) == 4
    for want in golden["records"]:
        have = got[(want["key"], want["routing"])]
        for field, value in want.items():
            if field not in WALL_FIELDS:
                assert have[field] == value, (want["key"], field)


@pytest.mark.parametrize("grid", ["mini", "minicredit"])
def test_check_is_clean_on_the_ports_outputs(runs, grid):
    _, _, wd = runs[grid]
    args = ["--check", "--md", str(wd / "EXP.md"), "--json", str(wd / "BENCH.json"),
            "--sweeps-dir", str(wd / "sweeps")]
    assert report.main(args) == 0
    text = (wd / "EXP.md").read_text()
    assert "`python -m repro_torch.experiments.run --grid" in text and "backend `torch`" in text
    assert "python -m repro.experiments" not in text


def test_main_without_a_device_raises_on_a_host_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(_argv(tmp_path, "mini"))
    assert not any(tmp_path.iterdir())  # refused before anything was written


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """`--grid paper` (its own scale, 0.01) and `--grid minifaults` with every
    path left at its default, from an empty working directory."""
    wd = tmp_path_factory.mktemp("defaults")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        assert run_main(["--grid", "paper", "--device", "cpu", "-q"]) == 0
        assert run_main(["--grid", "minifaults", "--device", "cpu", "-q"]) == 0
        assert report.main(["--check"]) == 0
    finally:
        os.chdir(cwd)
    return wd


def test_default_paths_stay_under_artifacts_torch(default_run):
    written = sorted(p.relative_to(default_run).as_posix() for p in default_run.rglob("*") if p.is_file())
    assert written and all(p.startswith("artifacts/torch/") for p in written), written
    for path in ("EXPERIMENTS.md", "BENCH_sweep.json", "sweeps/minifaults.json", "journals/minifaults.json"):
        assert f"artifacts/torch/{path}" in written
    assert any(p.startswith("artifacts/torch/sweep_cache/") for p in written)


def test_paper_records_equal_the_committed_bench(default_run):
    """The paper grid at its own scale against the reference's committed
    numpy run of the same grid, scale and seed (`BENCH_sweep.json`) and the
    frozen amazon slice: every field but the wall time, bit for bit."""
    port = json.loads((default_run / "artifacts" / "torch" / "BENCH_sweep.json").read_text())
    bench = json.loads((ROOT / "BENCH_sweep.json").read_text())
    assert port["grid"] == bench["grid"] and port["backend"] == "torch"
    assert [r["key"] for r in port["records"]] == [r["key"] for r in bench["records"]]
    for a, b in zip(port["records"], bench["records"]):
        assert _without(a, WALL_FIELDS) == _without(b, WALL_FIELDS), a["key"]
    assert port["workload_stats"] == bench["workload_stats"]
    got = {r["key"]: r for r in port["records"]}
    golden = json.loads((FIXTURES / "golden_paper_amazon.json").read_text())
    assert len(golden["records"]) == 12
    for want in golden["records"]:  # every frozen field (the fixture predates `scale_in_key`)
        have = got[want["key"]]
        for field, value in want.items():
            if field not in WALL_FIELDS:
                assert have[field] == value, (want["key"], field)


def _run_cli(workdir: pathlib.Path, grid: str, *extra: str, trace_out=None, metrics_out=None):
    workdir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.experiments.run", *_argv(workdir, grid, "--device", "cpu"), *extra]
    if trace_out:
        cmd += ["--trace-out", str(trace_out)]
    if metrics_out:
        cmd += ["--metrics-out", str(metrics_out)]
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_OBS_DETERMINISTIC="1")
    env.pop("REPRO_FAULTS_UNIT_DELAY", None)
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=560, env=env)
    assert done.returncode == 0, done.stderr[-2000:]


class TestPipelineByteIdentity:
    def test_tracing_on_vs_off_identical_mini_artifacts(self, tmp_path):
        a, b = tmp_path / "off", tmp_path / "on"
        trace, mets = b / "trace.json", b / "metrics.json"
        _run_cli(a, "mini")
        _run_cli(b, "mini", trace_out=trace, metrics_out=mets)
        for name in ("EXP.md", "BENCH.json"):
            assert (a / name).read_bytes() == (b / name).read_bytes(), f"{name} differs with tracing on"

        assert validate_file(str(trace), TRACE_SCHEMA) == []
        payload = json.loads(trace.read_text())
        names = {e["name"] for e in payload["traceEvents"] if e["ph"] == "X"}
        assert {"pipeline.sweep", "pipeline.report", "sweep.trace", "sweep.placement", "sweep.simulate"} <= names
        counters = [e for e in payload["traceEvents"] if e["ph"] == "C"]
        assert counters and counters[0]["name"].startswith("link")
        assert payload["otherData"]["deterministic_clock"] is True

        assert validate_file(str(mets), METRICS_SCHEMA) == []
        snap = json.loads(mets.read_text())
        assert "placement" in metrics.series_map(snap, "sweep.stage_seconds", "stage")
        assert "placement.stats" in snap["comparable"]

        heat = json.loads((b / "trace.heatmap.json").read_text())
        assert heat["tracks"] and all("mean_util" in t for t in heat["tracks"])

    def test_resume_with_metrics_keeps_faults_artifact_identical(self, tmp_path):
        m1, m2 = tmp_path / "m1.json", tmp_path / "m2.json"
        _run_cli(tmp_path, "minifaults", metrics_out=m1)
        artifact = tmp_path / "sweeps" / "minifaults.json"
        first = artifact.read_bytes()
        _run_cli(tmp_path, "minifaults", "--resume", metrics_out=m2)
        assert artifact.read_bytes() == first

        a, b = json.loads(m1.read_text()), json.loads(m2.read_text())
        assert validate_file(str(m1), METRICS_SCHEMA) == []
        assert a["comparable"] == b["comparable"]
        runs1 = metrics.series_map(a, "faults.unit_runs", "kind")
        runs2 = metrics.series_map(b, "faults.unit_runs", "kind")
        assert runs1.get("computed", 0) > 0 and "resumed" not in runs1
        assert runs2.get("resumed", 0) == runs1["computed"] and "computed" not in runs2


def test_torus_sweep_smoke_through_run_cli(tmp_path):
    """`--grid torus --scale 0.001` through the port's CLI: the artifact the
    §Torus section renders, with the reference test's counts and claims."""
    rc = run_main([
        "--grid", "torus", "--scale", "0.001",
        "--cache-dir", str(tmp_path / "cache"),
        "--sweeps-dir", str(tmp_path / "sweeps"),
        "--no-serial-check", "--backend", "torch", "--device", "cpu", "-q",
    ])
    assert rc == 0
    payload = json.loads((tmp_path / "sweeps" / "torus.json").read_text())
    assert len(payload["records"]) == 72 and payload["backend"] == "torch"
    ps = payload["placement_stats"]
    assert ps["batched_configs"] == 36 and ps["greedy_constructed"] == 24
    assert ps["torus_constructed"] == 12 and ps["serial_configs"] == 24
    cells = {}
    for r in payload["records"]:
        key = (r["workload"], r["algorithm"], r["partitioner"], r["placement"], r["num_parts"])
        cells.setdefault(key, {})[r["topology"]] = r
    baseline_gains = [
        pair["mesh2d"]["sim_avg_hops"] / pair["torus2d"]["sim_avg_hops"]
        for key, pair in cells.items()
        if key[2] == "random" and key[3] == "random" and "mesh2d" in pair and "torus2d" in pair
    ]
    assert len(baseline_gains) == 12 and min(baseline_gains) > 1.1, baseline_gains
    greedy_h = {
        key[:2] + key[4:]: pair["torus2d"]["sim_byte_hops"]
        for key, pair in cells.items()
        if key[2] == "powerlaw" and key[3] == "greedy" and "torus2d" in pair
    }
    cons = {
        key[:2] + key[4:]: pair["torus2d"]
        for key, pair in cells.items()
        if key[2] == "powerlaw" and key[3] == "auto" and "torus2d" in pair
    }
    assert len(cons) == len(greedy_h) == 12
    for cell_key, rec in cons.items():
        assert rec["placement_method"] == "torus_quad"
        assert rec["sim_byte_hops"] <= greedy_h[cell_key] * (1 + 1e-9), cell_key
    section = report._torus_section(payload)
    assert "§Torus" in section and "wrap-link" in section.lower()
    assert "Constructive torus layouts vs greedy+2-opt" in section
    assert "search-time saving" in section
