"""The journaled resilience runner of `repro_torch.experiments.resilience`
against `repro.experiments.resilience`, on the CPU: `minifaults` gives the
reference's numpy records (the port's torch arm ran beside them and agreed
bit for bit on the open arm); a resumed run serves every unit from the
journal and gives a byte-identical payload, a partial journal resumes to the
same payload, and a failing unit lands on the quarantine list."""
import dataclasses
import json
import signal
import time

import pytest

from repro.experiments import GRIDS as JAX_GRIDS
from repro.experiments.resilience import run_resilience as jax_run_resilience
from repro_torch.experiments import resilience
from repro_torch.experiments.grid import GRIDS
from repro_torch.experiments.journal import SweepJournal, UnitTimeout, flush_all_journals, unit_timeout
from repro_torch.experiments.resilience import fault_seed, run_resilience, unit_ids
from repro_torch.obs import metrics

GRID = GRIDS["minifaults"]


def _dump(result) -> str:
    return json.dumps(result.to_dict(), sort_keys=True)


@pytest.fixture(scope="module")
def runs():
    ref = jax_run_resilience(JAX_GRIDS["minifaults"], backend="numpy")
    mine_numpy = run_resilience(GRID, backend="numpy", device="cpu")
    mine_torch = run_resilience(GRID, backend="torch", device="cpu")
    return ref, mine_numpy, mine_torch


def test_numpy_backend_gives_the_reference_payload(runs):
    ref, mine, _ = runs
    assert mine.backend == ref.backend == "numpy" and mine.backend_parity_max_rel is None
    assert json.dumps(mine.to_dict()["faults"], sort_keys=True) == json.dumps(ref.to_dict()["faults"], sort_keys=True)
    assert dataclasses.asdict(mine.grid) == dataclasses.asdict(ref.grid)
    assert [r["unit_id"] for r in mine.records] == unit_ids(GRID) == ["amazon/bfs/mesh2d/P4@r0", "amazon/bfs/mesh2d/P4@r0.05"]


def test_torch_arm_runs_beside_the_reference_records(runs):
    ref, _, mine = runs
    assert mine.backend == "numpy+torch"
    assert mine.backend_parity_max_rel == 0.0  # the open arm is bit-identical
    for a, b in zip(mine.records, ref.records):
        assert a["backend_parity_rel"] == 0.0 and b["backend_parity_rel"] is None
        assert {**a, "backend_parity_rel": None} == b
    assert mine.repair == ref.repair and all(r["batch_parity"] for r in mine.repair)
    assert len(mine.repair) == 3  # the fault-free unit, three repair budgets
    assert mine.quarantined == {}
    assert mine.records[1]["num_dead_links"] > 0 and mine.records[1]["win"] > 0


def test_fault_seed_is_the_references():
    from repro.experiments.resilience import fault_seed as jax_fault_seed

    for args in (("amazon", "mesh2d", 16, 0.05), ("soc-pokec", "torus2d", 4, 0.0)):
        assert fault_seed(*args) == jax_fault_seed(*args)


def test_resume_serves_every_unit_from_the_journal(runs, tmp_path):
    _, _, mine = runs
    path = tmp_path / "journal.json"
    first = run_resilience(GRID, device="cpu", journal=SweepJournal(path, GRID.name, resume=False))
    assert _dump(first) == _dump(mine)
    journal = json.loads(path.read_text())
    assert list(journal["units"]) == unit_ids(GRID) and journal["quarantine"] == {}

    reg = metrics.MetricsRegistry()
    calls = []
    again = run_resilience(GRID, device="cpu", journal=SweepJournal(path, GRID.name, resume=True),
                           progress=calls.append)
    assert _dump(again) == _dump(first)
    assert sum("(journaled)" in c for c in calls) == len(unit_ids(GRID))
    assert again.cache_stats["trace_misses"] == 0  # a fully journaled resume never traces
    resilience.register_resilience_metrics(again, resumed=2, computed=0, reg=reg)
    snap = reg.snapshot()
    assert "faults.units" in snap["comparable"] and "faults.unit_runs" in snap["non_comparable"]


def test_partial_journal_resumes_to_the_same_payload(runs, tmp_path):
    _, _, mine = runs
    path = tmp_path / "journal.json"
    run_resilience(GRID, device="cpu", journal=SweepJournal(path, GRID.name, resume=False))
    data = json.loads(path.read_text())
    first_uid = unit_ids(GRID)[0]
    data["units"] = {first_uid: data["units"][first_uid]}  # as if killed after one unit
    path.write_text(json.dumps(data, indent=1))
    resumed = run_resilience(GRID, device="cpu", journal=SweepJournal(path, GRID.name, resume=True))
    assert _dump(resumed) == _dump(mine)
    with pytest.raises(ValueError, match="belongs to grid"):
        SweepJournal(path, "minicredit", resume=True)


def test_a_failing_unit_is_quarantined_and_retried_on_resume(tmp_path, monkeypatch):
    path = tmp_path / "journal.json"
    real = resilience._run_unit

    def flaky(uid, *a, **kw):
        if uid.endswith("@r0.05"):
            raise RuntimeError("injected")
        return real(uid, *a, **kw)

    monkeypatch.setattr(resilience, "_run_unit", flaky)
    res = run_resilience(GRID, backend="numpy", device="cpu",
                         journal=SweepJournal(path, GRID.name, resume=False))
    assert len(res.records) == 1
    assert res.quarantined == {"amazon/bfs/mesh2d/P4@r0.05": {"error": "injected", "kind": "RuntimeError"}}
    monkeypatch.setattr(resilience, "_run_unit", real)
    again = run_resilience(GRID, backend="numpy", device="cpu",
                           journal=SweepJournal(path, GRID.name, resume=True))
    assert len(again.records) == 2 and again.quarantined == {}
    assert flush_all_journals() >= 0


def test_unit_timeout_raises_on_the_main_thread():
    with pytest.raises(UnitTimeout):
        with unit_timeout(0.05):
            time.sleep(1.0)
    with unit_timeout(0):  # disabled
        pass
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_runner_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="no fault_rates"):
        run_resilience(GRIDS["mini"], device="cpu")
    with pytest.raises(ValueError, match="pair exactly"):
        run_resilience(dataclasses.replace(GRID, placements=("quad", "greedy")), device="cpu")
