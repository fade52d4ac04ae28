"""`repro_torch.launch.dryrun` and the dry-run cases of `configs.base`: the
cells and batch specs against the reference's, production cells counted on
'meta', the collectives' counted bytes against the lifted byte counters on a
(2, 4) stacked mesh and over gloo, FAIL records, the report's tables over
the reference's committed records, and the train loop's zero gradient for a
leaf the loss does not read (graphcast), as jax.grad gives."""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as ref_get_arch
from repro.experiments import report as ref_report
from repro.models import gnn as ref_gnn
from repro_torch.configs.registry import ARCH_IDS, arch_ids, get_arch
from repro_torch.experiments import report
from repro_torch.graph.distributed import make_mesh
from repro_torch.launch import dryrun
from repro_torch.launch import report as launch_report
from repro_torch.launch.roofline import dense_serve_bytes, dense_step_bytes, moe_tp_bytes, received_bytes
from repro_torch.models import gnn
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import MeshRules
from repro_torch.obs.cost import CostCounter
from repro_torch.train.loop import make_train_step
from repro_torch.train.optim import adamw
from repro_torch.train.pytree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "artifacts" / "dryrun"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_skips_equal_the_reference(arch):
    assert get_arch(arch).shape_cells() == ref_get_arch(arch).shape_cells()
    assert get_arch(arch).skipped_cells() == ref_get_arch(arch).skipped_cells()


@pytest.mark.parametrize("arch", arch_ids("gnn"))
def test_gnn_batch_specs_equal_the_reference(arch):
    for cell in get_arch(arch).shape_cells():
        for n_dev in (256, 512):
            got, got_p = get_arch(arch).batch_specs(cell, n_dev)
            want, want_p = ref_get_arch(arch).batch_specs(cell, n_dev)
            assert list(got) == list(want) and list(got_p) == list(want_p)
            for k, w in want.items():
                assert tuple(got[k].shape) == w.shape and got[k].device.type == "meta", (cell, k)
                assert str(got[k].dtype).removeprefix("torch.") == np.dtype(w.dtype).name, (cell, k)
                assert tuple(got_p[k]) == tuple(want_p[k]), (cell, k)


CELLS = [("llama3.2-3b", "decode_32k", False), ("olmoe-1b-7b", "decode_32k", False),
         ("dcn-v2", "serve_p99", False), ("gin-tu", "molecule", True)]


@pytest.mark.parametrize("arch,cell,multi", CELLS)
def test_a_production_cell_counts_on_meta(arch, cell, multi):
    rec = dryrun.run_cell(arch, cell, multi_pod=multi, verbose=False)
    with open(COMMITTED / f"{arch}__{cell}__{rec['mesh']}.json") as f:
        ref = json.load(f)
    assert set(ref) - {"lower_s", "compile_s"} <= set(rec) and "count_s" in rec
    assert rec["status"] == "ok" and rec["chips"] == ref["chips"]
    assert rec["model_flops"] == ref["model_flops"]
    if arch == "dcn-v2":  # the reference's yardstick takes each multiply-add as four FLOPs: useful/HLO ≈ 2
        assert rec["hlo_flops"] * rec["chips"] == pytest.approx(_dcn_forward_flops(cell), rel=1e-12)
        assert 1.9 < rec["useful_flops_ratio"] < 2.1
    else:
        assert 0.0 < rec["useful_flops_ratio"] <= 1.0
    assert rec["hlo_bytes"] > 0 and rec["bytes_per_device"] > 0 and rec["device"] == "meta"
    if arch.startswith(("llama", "olmoe")):
        assert rec["coll_bytes"] > 0 and "all-gather" in rec["coll_breakdown"]
    if arch == "olmoe-1b-7b":
        assert rec["coll_breakdown"]["all-to-all"] > 0  # EP over "model"


def _dcn_forward_flops(cell: str) -> float:
    """A hand count of dcn-v2's forward: two FLOPs a multiply-add of the
    cross layers' and the tower's matrices and of the bag's gathered slots."""
    from repro_torch.configs.base import RECSYS_SHAPES

    cfg, b = get_arch("dcn-v2").model_config(), RECSYS_SHAPES[cell]["batch"]
    dims = [cfg.d_input, *cfg.mlp_dims, 1]
    products = cfg.n_cross_layers * cfg.d_input ** 2 + sum(p * q for p, q in zip(dims[:-1], dims[1:]))
    return 2.0 * b * (products + cfg.n_sparse * cfg.embed_dim)


def _numbers(d: dict) -> float:
    return sum(v for v in d.values() if isinstance(v, (int, float)) and not isinstance(v, bool))


MESH = ((2, 4), ("data", "model"))


@pytest.mark.parametrize("strategy", ["tp_sp", "fsdp"])
def test_counted_bytes_equal_the_dense_byte_counters(strategy):
    mesh = make_mesh(*MESH, device="cpu")
    cfg = dataclasses.replace(get_arch("llama3.2-3b").smoke_config(), rules=MeshRules(strategy=strategy))
    params = tfm.shard_params(tfm.init_params(cfg, 0, device="cpu"), cfg, mesh)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (8, 16)))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    with CostCounter() as c:
        torch.autograd.grad(tfm.loss_fn(params, {"tokens": toks, "labels": toks}, cfg, mesh=mesh), leaves)
    want = dense_step_bytes(cfg, mesh, 8, 16)
    got = received_bytes(c, mesh.num_engines)
    assert got["all-gather"] == want["fsdp_gathers"] + want["cross_entropy"] / 3  # the row max's gather
    assert sum(got.values()) == _numbers(want)
    with torch.no_grad():
        for rows, seq, split in ((1, 32, False), (8, 1, True)):
            cache = tfm.init_kv_cache(cfg, 8, 64, device="cpu", mesh=mesh, dtype=torch.float32)
            ids = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (rows, seq)))
            with CostCounter() as c:
                if seq > 1:
                    tfm.prefill(params, ids, cache, cfg, mesh=mesh, slot=0)
                else:
                    tfm.decode_step_batched_pos(params, cache, torch.full((8,), 5), ids, cfg, mesh=mesh)
            want = dense_serve_bytes(cfg, mesh, rows, seq, split)
            assert sum(received_bytes(c, mesh.num_engines).values()) == _numbers(want), (rows, seq)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_counted_bytes_equal_the_moe_byte_counter(arch):
    mesh = make_mesh(*MESH, device="cpu")
    base = get_arch(arch).smoke_config()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, impl="ep_shardmap"))
    params = tfm.shard_params(tfm.init_params(cfg, 0, device="cpu"), cfg, mesh)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for rows, seq, split in ((1, 32, False), (8, 1, True), (8, 4, True)):
            cache = tfm.init_kv_cache(cfg, 8, 64, device="cpu", mesh=mesh, dtype=torch.float32)
            ids = torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq)))
            with CostCounter() as c:
                if seq == 1:
                    tfm.decode_step_batched_pos(params, cache, torch.full((8,), 5), ids, cfg, mesh=mesh)
                else:
                    tfm.prefill(params, ids, cache, cfg, mesh=mesh, slot=0 if rows == 1 else None)
            want = {k: v for k, v in moe_tp_bytes(cfg, mesh, rows, seq, split).items()
                    if k not in ("ep_tokens_an_engine", "Cs")}
            got = received_bytes(c, mesh.num_engines)
            assert got["all-to-all"] == want["ep_all_to_alls"]
            assert sum(got.values()) == _numbers(want), (rows, seq)


def test_gloo_ranks_count_what_the_stacked_mesh_counts(tmp_path):
    ranks = run_gloo("counted", tmp_path)
    want = JOBS["counted"](make_job_mesh("counted", "stacked"))
    assert set(want) == {f"{k}/{v}" for k in ("tp_sp", "fsdp", "olmoe_ep") for v in ("coll", "calls")}
    for r, got in enumerate(ranks):
        for k, v in want.items():
            assert np.array_equal(got[k], v), (r, k)
    assert want["tp_sp/coll"].sum() > 0 and want["fsdp/coll"].sum() > 0
    assert want["olmoe_ep/coll"][3] > 0  # EP's all-to-alls, forward and backward


def test_a_cell_that_raises_is_a_fail_record_and_the_sweep_exits_1(tmp_path, monkeypatch, capsys):
    def boom(arch_id, cell, **_):
        raise RuntimeError(f"no count for {cell}")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    monkeypatch.setattr(dryrun, "ARCH_IDS", ["gin-tu"])
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 1
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 4 and all(r["status"] == "FAIL" and "no count" in r["error"] for r in recs)
    assert "0 ok / 4 fail" in capsys.readouterr().out


def test_report_tables_render_the_committed_records_as_the_reference():
    ports, refs = report.load_dryrun_records(str(COMMITTED)), ref_report.load_dryrun_records(str(COMMITTED))
    assert len(ports) == 70
    assert report.dryrun_table(ports) == ref_report.dryrun_table(refs)
    assert report.roofline_table(ports) == ref_report.roofline_table(refs)
    assert report.dryrun_summary(ports) == ref_report.dryrun_summary(refs)


def test_report_renders_the_port_records(tmp_path, capsys):
    dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--out", str(tmp_path)])
    launch_report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "| count (s) |" in out and "| gin-tu | molecule | 16x16 | ok |" in out
    assert "| gin-tu | molecule | 2x16x16 | ok |" in out and "records: 2 ok, 0 fail" in out


def _graphcast_batch(cfg, rng) -> dict:
    n, m = 40, 12
    b = {"x": rng.standard_normal((n, cfg.d_in), np.float32), "mesh_x": rng.standard_normal((m, 3), np.float32),
         "labels": rng.standard_normal((n, cfg.n_vars), np.float32), "node_mask": np.ones(n, bool)}
    for pre, (ns, nd), e in (("g2m", (n, m), 60), ("m2m", (m, m), 30), ("m2g", (m, n), 50)):
        b[f"{pre}_src"] = rng.integers(0, ns, e).astype(np.int32)
        b[f"{pre}_dst"] = rng.integers(0, nd, e).astype(np.int32)
        b[f"{pre}_feat"] = rng.standard_normal((e, 4), np.float32)
        b[f"{pre}_mask"] = np.ones(e, bool)
    return b


def test_a_leaf_the_loss_does_not_read_gets_a_zero_gradient_as_jax_grad():
    """graphcast's output MLP has no final norm: its `ln` is never read.  The
    reference's jax.grad gives it 0; the port's train step did raise."""
    cfg = get_arch("graphcast").smoke_config()
    batch = _graphcast_batch(cfg, np.random.default_rng(9))
    ref_cfg = ref_get_arch("graphcast").smoke_config()
    ref_grads = jax.grad(lambda p: ref_gnn.loss_fn(p, batch, ref_cfg))(ref_gnn.init_params(ref_cfg, jax.random.key(0)))
    assert not np.asarray(ref_grads["head"]["out"]["ln"]).any()
    params = gnn.init_params(cfg, 0, device="cpu")
    before = params["head"]["out"]["ln"].clone()
    init, step = make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg), adamw(1e-3))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, metrics = step(init(params), tb)
    assert np.isfinite(float(metrics["loss"]))
    # a zero gradient: AdamW moves the leaf by its weight decay alone
    assert torch.equal(state.opt_state["mu"]["head"]["out"]["ln"], torch.zeros_like(before))
    assert torch.allclose(state.params["head"]["out"]["ln"], before * (1 - 1e-3 * 0.1), rtol=0, atol=1e-7)
