"""`repro_torch.launch.perf`: the variants against the reference's on the
reference's configs, the halo plan's batch against `batch_specs_halo`'s
reference, the CLI (a variant and the halo GIN, deltas against the
baseline), and `measure_cell`, which refuses to run off the card."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.graph.halo import build_halo_plan as ref_build_halo_plan
from repro.graph.halo import plan_sizes as ref_plan_sizes
from repro.models.gnn_dist import batch_specs_halo as ref_batch_specs_halo
from repro_torch.configs.registry import get_arch
from repro_torch.graph.generators import rmat
from repro_torch.graph.halo import build_halo_plan, plan_sizes
from repro_torch.launch import perf
from repro_torch.models.gnn_dist import batch_specs_halo


def _reference_perf():
    """`repro.launch.perf`, whose import sets XLA_FLAGS to 512 host devices
    for its dry run (it imports no JAX itself): the variable is put back, so
    this process's JAX, whenever it starts, keeps its own device count."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as ref_perf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_perf


def _value(v):
    """A config field comparable across the packages: dtypes by name, rules
    by strategy."""
    if hasattr(v, "strategy"):
        return ("rules", v.strategy, v.multi_pod)
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    try:
        return jnp.dtype(v).name
    except TypeError:
        return v


def _changed(before, after) -> dict:
    return {f.name: _value(getattr(after, f.name)) for f in dataclasses.fields(before)
            if _value(getattr(before, f.name)) != _value(getattr(after, f.name))}


@pytest.mark.parametrize("variant", sorted(perf.VARIANTS))
def test_each_variant_sets_what_the_reference_variant_sets(variant):
    ref_perf = _reference_perf()
    assert set(perf.VARIANTS) == set(ref_perf.VARIANTS)
    arch = "dcn-v2" if variant == "psum_embed" else "llama3.2-3b"
    ref_cfg, cfg = ref_get_arch(arch).model_config(), get_arch(arch).model_config()
    want = _changed(ref_cfg, ref_perf.VARIANTS[variant](ref_cfg))
    got = _changed(cfg, perf.VARIANTS[variant](cfg))
    assert want and got == want


@pytest.mark.parametrize("parts", [4, 8])
def test_halo_batch_specs_equal_the_reference(parts):
    g = rmat(400, 3000, seed=1)
    sizes = plan_sizes(build_halo_plan(g.src, g.dst, g.num_nodes, parts))
    assert sizes == ref_plan_sizes(ref_build_halo_plan(g.src, g.dst, g.num_nodes, parts))
    got, want = batch_specs_halo(sizes, 100, 16), ref_batch_specs_halo(sizes, 100, 16)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].device.type == "meta", k
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(w.dtype).name, k


def test_the_cli_counts_a_variant_and_prints_its_deltas(tmp_path, capsys):
    out, base = tmp_path / "perf", tmp_path / "base"
    perf.main(["--arch", "llama3.2-3b", "--shape", "decode_32k", "--variant", "bf16params", "--out", str(out),
               "--baseline-dir", str(base)])
    rec = json.loads((out / "llama3.2-3b__decode_32k__16x16__bf16params.json").read_text())
    assert rec["variant"] == "bf16params" and rec["status"] == "ok" and rec["device"] == "meta"
    text = capsys.readouterr().out
    assert "--- vs baseline ---" in text and "bytes_per_device" in text  # the weights halve
    perf.main(["--arch", "dcn-v2", "--shape", "serve_p99", "--variant", "psum_embed", "--out", str(out),
               "--baseline-dir", str(base)])
    rec = json.loads((out / "dcn-v2__serve_p99__16x16__psum_embed.json").read_text())
    assert rec["kernels"] == {"embedding_bag": 16} and rec["coll_breakdown"]["all-reduce"] > 0  # a bag a data row


def test_the_cli_counts_the_halo_gin(tmp_path, capsys):
    out = tmp_path / "perf"
    perf.main(["--arch", "gin-tu", "--shape", "ogb_products", "--variant", "halo", "--graph-scale", "0.0005",
               "--parts", "8", "--out", str(out), "--baseline-dir", str(tmp_path / "base")])
    rec = json.loads((out / "gin-tu__ogb_products__8__halo.json").read_text())
    assert rec["variant"] == "halo" and rec["chips"] == 8 and rec["coll_breakdown"]["all-to-all"] > 0
    assert rec["kernels"] == {"segment_spmm": 9}  # 5 reduces forward, 4 transposes backward
    assert "--- vs baseline ---" in capsys.readouterr().out


def test_measure_cell_needs_the_card():
    with pytest.raises(RuntimeError, match="on the card"):
        perf.measure_cell("dcn-v2", "serve_bulk", cut={"batch": 8}, device="cpu")
