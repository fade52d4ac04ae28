"""The port's report writer and freshness audit (`repro_torch.experiments.
report`), held against the reference package's report tests and its tables.

The counterparts of the report tests of `tests/test_experiments_sweep.py`
and `tests/test_nocsim.py` run on the port's sweeps (torch backend, on the
CPU); `--check` reads the port's payload keys (`credit_inf_torch_max_rel`,
the numpy↔torch parity).  And the two reports are one table for table: every
row of the port's report equals the reference's on the same grid, but for
the §Perf stage table, whose rows are wall times."""
import dataclasses
import json
import os

import pytest

from repro.experiments import report as jax_report
from repro.experiments.grid import GRIDS as JAX_GRIDS
from repro.experiments.resilience import run_resilience as jax_run_resilience
from repro.experiments.sweep import run_sweep as jax_run_sweep
from repro_torch.experiments import report
from repro_torch.experiments.grid import GRIDS, grid_by_name
from repro_torch.experiments.resilience import run_resilience
from repro_torch.experiments.sweep import run_sweep


def _sweep(grid, **kw):
    return run_sweep(grid, cache_dir=None, measure_serial=False, backend="torch", device="cpu", **kw)


@pytest.fixture(scope="module")
def mini_sweep():
    return _sweep(grid_by_name("mini"))


@pytest.fixture(scope="module")
def minicredit_sweep():
    return _sweep(GRIDS["minicredit"])


def _tiny_contention(grids):
    return dataclasses.replace(
        grids["contention"],
        workloads=("amazon",),
        algorithms=("bfs",),
        parts=(4,),
        scale=0.001,
        placements=("greedy", "random"),  # no exact MILP; greedy covers torus3d
    )


@pytest.fixture(scope="module")
def tiny_contention_sweep():
    return _sweep(_tiny_contention(GRIDS))


def _write(res, tmp_path, sweeps="sweeps"):
    return report.write_outputs(
        res,
        md_path=str(tmp_path / "E.md"),
        json_path=str(tmp_path / "B.json"),
        dryrun_dir=str(tmp_path / "nodir"),
        perf_dir=str(tmp_path / "nodir"),
        sweeps_dir=str(tmp_path / sweeps),
    )


def _renamed(res, name):
    return dataclasses.replace(res, grid=dataclasses.replace(res.grid, name=name))


# ---------------------------------------------------------------------------
# from tests/test_experiments_sweep.py
# ---------------------------------------------------------------------------


def test_report_writer_outputs_both_files(tmp_path, mini_sweep):
    md, js = _write(mini_sweep, tmp_path, "nodir")
    text = open(md).read()
    for section in ("## §Calibration", "## §Dry-run", "## §Roofline", "## §Perf", "## Fig. 5", "## Fig. 7"):
        assert section in text, section
    assert "`python -m repro_torch.launch.dryrun" in text  # no dry-run records here: where they come from
    payload = json.load(open(js))
    assert payload["records"] and payload["comparisons"]
    assert payload["grid"]["name"] == "mini" and payload["backend"] == "torch"
    assert payload["placement_stats"]["batched_configs"] >= 1


def test_extra_sweep_artifacts_render_sections(tmp_path, mini_sweep):
    for name in ("ablation", "meshscale", "torus"):
        report.save_sweep_artifact(_renamed(mini_sweep, name), str(tmp_path / "sweeps"))
    md, _ = _write(mini_sweep, tmp_path)
    text = open(md).read()
    assert "## §Ablation" in text and "## §Mesh scaling" in text and "## §Torus" in text


class TestFreshnessAudit:
    def test_fresh_report_passes(self, tmp_path, mini_sweep):
        md, js = _write(mini_sweep, tmp_path)
        assert report.experiments_md_issues(md, js, str(tmp_path / "sweeps")) == []

    def test_unrendered_sweep_artifact_is_stale(self, tmp_path, mini_sweep):
        md, js = _write(mini_sweep, tmp_path)
        report.save_sweep_artifact(_renamed(mini_sweep, "torus"), str(tmp_path / "sweeps"))
        issues = report.experiments_md_issues(md, js, str(tmp_path / "sweeps"))
        assert issues and "torus" in issues[0] and "repro_torch.experiments.run" in issues[0]

    def test_rendered_section_with_missing_artifact_is_stale(self, tmp_path, mini_sweep):
        sweeps = tmp_path / "sweeps"
        report.save_sweep_artifact(_renamed(mini_sweep, "torus"), str(sweeps))
        md, js = _write(mini_sweep, tmp_path)
        assert report.experiments_md_issues(md, js, str(sweeps)) == []
        os.remove(sweeps / "torus.json")  # the report still renders §Torus
        issues = report.experiments_md_issues(md, js, str(sweeps))
        assert issues and "torus" in issues[0] and "missing" in issues[0]

    def test_mismatched_payload_is_stale(self, tmp_path, mini_sweep):
        md, js = _write(mini_sweep, tmp_path)
        payload = json.load(open(js))
        payload["records"] = payload["records"][:-1]  # drift the config count
        json.dump(payload, open(js, "w"))
        issues = report.experiments_md_issues(md, js, str(tmp_path / "sweeps"))
        assert issues and "config count" in issues[0]

    def test_check_cli_exit_codes(self, tmp_path, mini_sweep):
        md, js = _write(mini_sweep, tmp_path)
        args = ["--check", "--md", md, "--json", js, "--sweeps-dir", str(tmp_path / "sweeps")]
        assert report.main(args) == 0
        os.remove(js)
        assert report.main(args) == 1


# ---------------------------------------------------------------------------
# from tests/test_nocsim.py
# ---------------------------------------------------------------------------


def _write_gate_inputs(tmp_path, name, payload):
    """A stand-in report holding exactly the markers the audit matches."""
    sweeps = tmp_path / "sweeps"
    sweeps.mkdir(exist_ok=True)
    md, js = tmp_path / "EXPERIMENTS.md", tmp_path / "BENCH_sweep.json"

    def write_all(p):
        (sweeps / f"{name}.json").write_text(json.dumps(p))
        md.write_text(
            f"## §{name} (`--grid {name}`)\n"
            f"**{len(payload['records'])} configurations**\n"
            f"scale {payload['grid']['scale']:g}; backend\n"
            f"`place_batch`: {payload['placement_stats']['batched_configs']} searched configs\n"
        )
        js.write_text(json.dumps(payload))
        return report.experiments_md_issues(str(md), str(js), str(sweeps))

    return write_all


def test_contention_section_renders(tiny_contention_sweep):
    text = report._contention_section(tiny_contention_sweep.to_dict())
    assert "`--grid contention`" in text
    assert "peak util (mapped)" in text
    assert "powerlaw+greedy" in text
    assert "strictly lower" in text
    assert "numpy↔torch" in text and "`repro_torch.nocsim.batch`" in text and "jax" not in text


def test_check_gates_contention_parity(tmp_path, tiny_contention_sweep):
    payload = tiny_contention_sweep.to_dict()
    write_all = _write_gate_inputs(tmp_path, "contention", payload)
    assert write_all(payload) == []
    bad = json.loads(json.dumps(payload))
    bad["contention"]["backend_parity_max_rel"] = 1e-3
    assert any("parity" in i and "torch steppers drifted" in i for i in write_all(bad))
    none = json.loads(json.dumps(payload))
    none["contention"]["backend_parity_max_rel"] = None
    assert any("numpy↔torch parity" in i and "--device" in i for i in write_all(none))
    worse = json.loads(json.dumps(payload))
    worse["contention"]["records"] = []
    assert any("no contended records" in i for i in write_all(worse))


def test_backpressure_section_renders(minicredit_sweep):
    text = report._backpressure_section(minicredit_sweep.to_dict())
    assert "`--grid backpressure`" in text
    assert "win d=1" in text and "win d=4" in text
    assert "retained-win ratio" in text
    assert "must be 0" in text and "torch max rel" in text and "jax" not in text


def test_check_gates_backpressure(tmp_path, minicredit_sweep):
    payload = minicredit_sweep.to_dict()
    write_all = _write_gate_inputs(tmp_path, "backpressure", payload)
    issues = write_all(payload)
    # the mini grid is mesh2d-only, so exactly the torus3d gate trips
    assert len(issues) == 1 and "torus3d" in issues[0]
    for mutate, needle in [
        (lambda p: p["contention"].update(credit_inf_numpy_max_abs=1e-9), "bit-identically"),
        (lambda p: p["contention"].update(credit_inf_torch_max_rel=1e-3), "infinite-credit torch"),
        (lambda p: p["contention"].update(credit_inf_torch_max_rel=None), "infinite-credit torch audit"),
        (lambda p: p["contention"].update(backend_parity_max_rel=1e-3), "parity"),
        (lambda p: p["contention"].update(
            records=[r for r in p["contention"]["records"] if r["flow_control"] != "credit"]),
         "no credit-arm records"),
        (lambda p: p["contention"].update(
            records=[r for r in p["contention"]["records"] if r["buffer_depth"] != 4.0]),
         "buffer_depth axis"),
    ]:
        bad = json.loads(json.dumps(payload))
        mutate(bad)
        issues = write_all(bad)
        assert any(needle in i for i in issues), (needle, issues)


def test_check_gates_resilience(tmp_path, mini_sweep):
    """A faults artifact from the numpy backend alone (no torch arm), or with
    quarantined units, is stale; the mini grid's two fault rates trip the
    rate-axis gate on their own."""
    faults = run_resilience(GRIDS["minifaults"], backend="torch", device="cpu").to_dict()
    sweeps = tmp_path / "sweeps"
    sweeps.mkdir()
    md, js = _write(mini_sweep, tmp_path)

    def issues_for(f):
        (sweeps / "faults.json").write_text(json.dumps(f))
        with open(md, "a") as fh:
            fh.write("\n`--grid faults`\n")
        return report.experiments_md_issues(md, js, str(sweeps))

    issues = issues_for(faults)
    assert len(issues) == 1 and "fault rate(s) [0.01, 0.02, 0.1]" in issues[0]
    numpy_only = json.loads(json.dumps(faults))
    numpy_only["faults"]["backend_parity_max_rel"] = None
    assert any("numpy↔torch parity" in i and "--backend torch" in i for i in issues_for(numpy_only))
    quarantined = json.loads(json.dumps(faults))
    quarantined["faults"]["quarantined"] = {"amazon/bfs/mesh2d/P4@r0.05": "boom"}
    assert any("quarantined" in i and "--resume" in i for i in issues_for(quarantined))


# ---------------------------------------------------------------------------
# the port's tables against the reference's
# ---------------------------------------------------------------------------


def _rows_by_section(text: str) -> list[tuple[str, str]]:
    section, rows = "", []
    for line in text.splitlines():
        if line.startswith("## "):
            section = line
        elif line.startswith("|"):
            rows.append((section, line))
    return rows


# The stage table of §Perf is the one whose rows carry wall times; no table
# row names the second arm (its parity is prose), so nothing else is left out.
EXCLUDED_SECTIONS = ("## §Perf",)


def _compared_rows(text: str) -> list[tuple[str, str]]:
    return [(s, r) for s, r in _rows_by_section(text) if not s.startswith(EXCLUDED_SECTIONS)]


@pytest.mark.parametrize("grid", ["mini", "minicredit"])
def test_report_tables_equal_the_references(tmp_path, grid, mini_sweep, minicredit_sweep):
    mine = {"mini": mini_sweep, "minicredit": minicredit_sweep}[grid]
    ref = jax_run_sweep(JAX_GRIDS[grid], cache_dir=None, measure_serial=False, backend="numpy")
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    md, _ = _write(mine, tmp_path / "port")
    nodir = str(tmp_path / "nodir")
    ref_md, _ = jax_report.write_outputs(
        ref, md_path=str(tmp_path / "ref" / "E.md"), json_path=str(tmp_path / "ref" / "B.json"),
        dryrun_dir=nodir, perf_dir=nodir, sweeps_dir=nodir,
    )
    got, want = _compared_rows(open(md).read()), _compared_rows(open(ref_md).read())
    assert len(got) > 20
    assert got == want
    if grid == "minicredit":  # the sections the contention payload renders
        for name in ("_contention_section", "_backpressure_section"):
            got = [r for _, r in _rows_by_section(getattr(report, name)(mine.to_dict()))]
            want = [r for _, r in _rows_by_section(getattr(jax_report, name)(ref.to_dict()))]
            assert len(got) > 4 and got == want, name


def test_resilience_tables_equal_the_references():
    mine = run_resilience(GRIDS["minifaults"], backend="torch", device="cpu").to_dict()
    ref = jax_run_resilience(JAX_GRIDS["minifaults"], backend="numpy").to_dict()
    got = [r for _, r in _rows_by_section(report._resilience_section(mine))]
    want = [r for _, r in _rows_by_section(jax_report._resilience_section(ref))]
    assert len(got) > 6 and got == want
