"""`repro_torch.launch.roofline`: the roofline terms against the reference's,
and `obs.cost.CostCounter` — the FLOPs of a smoke llama training step against a hand
count of its products, the same counts on 'cpu' and 'meta' for the smoke
llama, olmoe, gin-tu and dcn-v2 steps, and each kernel entry counted once on
both routes with nothing of its route counted again."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch.configs.registry import get_arch
from repro_torch.graph.generators import rmat
from repro_torch.graph.structs import build_ell
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import count_case
from repro_torch.launch.perf import cut_case, ell_to
from repro_torch.launch.roofline import Roofline
from repro_torch.obs import cost
from repro_torch.obs.cost import CostCounter

REF_HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
NUMBERS = [  # (chips, hlo_flops, hlo_bytes, coll_bytes, model_flops)
    (256, 1.05e14, 1.16e13, 6.27e11, 2.27e16),
    (512, 3.3e10, 8.1e9, 1.5e8, 1.0e12),
    (1, 0.0, 4.0e6, 0.0, 1.0e6),
]


def _pair(numbers, **port_kw):
    chips, f, b, c, m = numbers
    common = dict(arch="a", cell="c", mesh="16x16", chips=chips, hlo_flops=f, hlo_bytes=b, coll_bytes=c,
                  coll_breakdown={"all-reduce": c}, model_flops=m, bytes_per_device=1.0)
    return (ref_roofline.Roofline(**common, hw=ref_roofline.HW(**REF_HW)),
            Roofline(**common, hw=roofline.HW(**REF_HW), **port_kw))


def test_to_dict_keeps_the_reference_keys():
    ref, port = _pair(NUMBERS[0])
    d = port.to_dict()
    assert set(ref.to_dict()) <= set(d)
    assert {"flops_by_dtype", "device", "counted_by"} <= set(d) and "measured" not in d
    port.measured = {"s": 1.0}
    assert port.to_dict()["measured"] == {"s": 1.0}


@pytest.mark.parametrize("numbers", NUMBERS)
def test_terms_equal_the_reference_on_the_same_numbers_and_hw(numbers):
    ref, port = _pair(numbers)
    r, p = ref.to_dict(), port.to_dict()
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant", "useful_flops_ratio",
              "roofline_fraction"):
        assert p[k] == r[k], k


def test_compute_term_splits_by_dtype():
    _, port = _pair(NUMBERS[0], flops_by_dtype={"bfloat16": 8e13, "float32": 2.5e13})
    assert port.t_compute == pytest.approx(8e13 / 197e12 + 2.5e13 / 67e12, rel=1e-12)
    h100 = roofline.H100
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw, h100.f32_flops) == (989e12, 3.35e12, 450e9, 67e12)


def test_collective_kinds_and_ring_factors_equal_the_reference():
    assert roofline._COLLECTIVES == ref_roofline._COLLECTIVES
    for op in ref_roofline._COLLECTIVES:
        for g in (1, 2, 3, 4, 16, 256, 512):
            assert roofline._ring_factor(op, g) == ref_roofline._ring_factor(op, g), (op, g)


def test_attention_flops_closed_form_equals_the_loop():
    for sq, skv, off in ((128, 128, 0), (96, 160, 64), (100, 90, -40), (200, 328, 37), (7, 7, 100)):
        q, k = torch.empty(2, sq, 3, 8, device="meta"), torch.empty(2, skv, 1, 8, device="meta")
        pairs = sum(min(skv, max(0, i + off + 1)) for i in range(sq))
        assert cost.attention_flops(q, k, True, off) == 4.0 * 2 * 3 * 8 * pairs
        assert cost.attention_flops(q, k, False, off) == 4.0 * 2 * 3 * 8 * sq * skv


def _lm_cut(arch, cfg_of, b, s, device):
    return cut_case(arch, "train_4k", lambda _: cfg_of(get_arch(arch).smoke_config()), cut={"batch": b, "seq": s},
                    device=device, seed=3)


def test_smoke_llama_step_flops_equal_a_hand_count_of_its_products():
    cfg = get_arch("llama3.2-3b").smoke_config()
    b, s = 2, 16
    c = count_case(_lm_cut("llama3.2-3b", lambda c: c, b, s, "cpu"))
    t, d, dh, f = b * s, cfg.d_model, cfg.head_dim, cfg.d_ff
    layer = 2 * t * d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + 2 * t * cfg.n_heads * dh * d + 3 * 2 * t * d * f
    head = 2 * t * d * cfg.vocab
    q = torch.empty(b, s, cfg.n_heads, dh, device="meta")
    attn = cost.attention_flops(q, torch.empty(b, s, cfg.n_kv_heads, dh, device="meta"), True, 0)
    # a layer's products: forward, the recompute, and the backward's two — but w_down's, which the
    # recompute does not reach (the non-reentrant checkpoint stops once every saved tensor is back);
    # lm_head forward and backward's two; attention forward, the recompute and its backward (2.5 forwards)
    want = cfg.n_layers * (4 * layer - 2 * t * f * d + 4.5 * attn) + 3 * head
    assert dict(c.flops_by_dtype) == {"float32": want}
    assert dict(c.kernels) == {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}


def _gin_cut(device):
    g = rmat(200, 1500, seed=4)
    return cut_case("gin-tu", "ogb_products", lambda _: get_arch("gin-tu").smoke_config(), cut={"graph": g},
                    device=device, seed=5)


def _dcn_cut(cell):
    return lambda device: cut_case("dcn-v2", cell, lambda _: get_arch("dcn-v2").smoke_config(), cut={"batch": 64},
                                   device=device, seed=6)


STEPS = {
    "llama3.2-3b": lambda dev: _lm_cut("llama3.2-3b", lambda c: c, 2, 16, dev),
    "llama3.2-3b/bf16": lambda dev: _lm_cut("llama3.2-3b", lambda c: dataclasses.replace(c, dtype=torch.bfloat16),
                                            2, 16, dev),
    "olmoe-1b-7b": lambda dev: _lm_cut("olmoe-1b-7b", lambda c: c, 2, 16, dev),
    "qwen2-moe-a2.7b": lambda dev: _lm_cut("qwen2-moe-a2.7b", lambda c: c, 2, 8, dev),
    "gin-tu": _gin_cut,
    "dcn-v2/serve": _dcn_cut("serve_bulk"),
    "dcn-v2/train": _dcn_cut("train_batch"),
}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_cpu_and_meta_count_the_same(step):
    cpu, meta = count_case(STEPS[step]("cpu")), count_case(STEPS[step]("meta"))
    assert dict(cpu.flops_by_dtype) == dict(meta.flops_by_dtype)
    assert cpu.bytes == meta.bytes and cpu.bytes > 0
    assert dict(cpu.kernels) == dict(meta.kernels)


def _attention_inputs(dev, grad):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, h, 8), np.float32)).to(dev) for h in (4, 2, 2))
    return [t.requires_grad_(grad) for t in (q, k, v)]


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_attention_entry_counts_once_and_not_its_route(dev):
    q, k, v = _attention_inputs(dev, False)
    with CostCounter() as c:
        out = flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.device.type == dev
    assert dict(c.kernels) == {"flash_attention": 1}
    assert dict(c.flops_by_dtype) == {"float32": cost.attention_flops(q, k, True, 0)}
    assert c.bytes == cost.attention_fwd_bytes(q, k)
    q, k, v = _attention_inputs(dev, True)
    with CostCounter() as c:
        torch.autograd.grad(flash_attention(q, k, v, causal=True).sum(), [q, k, v])
    assert dict(c.kernels) == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert c.flops_by_dtype["float32"] == 3.5 * cost.attention_flops(q, k, True, 0)


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_reduce_and_bag_entries_count_once(dev):
    ell = build_ell(rmat(60, 300, seed=2).reversed(), device="cpu")
    ell.transpose = build_ell(rmat(60, 300, seed=2), device="cpu")
    ell = ell_to(ell, dev)
    x = torch.ones(60, 4, device=dev)
    with CostCounter() as c:
        out = segment_spmm(x, ell)
    flops, nbytes = cost.ell_reduce_cost(x, ell)
    assert out.shape == (60, 4) and dict(c.kernels) == {"segment_spmm": 1}
    assert (c.flops, c.bytes) == (flops, nbytes)
    with CostCounter() as c:
        torch.autograd.grad(segment_spmm(x.requires_grad_(True), ell).sum(), [x])
    assert dict(c.kernels) == {"segment_spmm": 2}
    tables = torch.zeros(3, 50, 8, device=dev)
    ids = torch.zeros(5, 3, 2, dtype=torch.int32, device=dev)
    with CostCounter() as c:
        out = embedding_bag(tables, ids)
    assert out.shape == (5, 3, 8) and dict(c.kernels) == {"embedding_bag": 1}
    assert (c.flops, c.bytes) == cost.bag_cost(tables, ids, None)


def test_views_count_no_bytes_and_copies_do():
    x = torch.zeros(8, 16, device="meta")
    with CostCounter() as c:
        x.view(16, 8).transpose(0, 1).reshape(8, 16)[2:].unsqueeze(0).expand(3, 6, 16)
    assert c.bytes == 0
    with CostCounter() as c:
        x.t().contiguous()
        torch.empty(8, 16, device="meta").copy_(x)
    assert c.bytes == 2 * 512 + 2 * 512


def test_the_kernels_and_the_mesh_import_no_launch_module():
    """The hooks the kernels and the mesh count through live in `obs.cost`:
    importing them pulls in nothing of `repro_torch.launch`."""
    import subprocess
    import sys

    code = ("import sys; import repro_torch.kernels.segment_spmm.ops, repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.embedding_bag.ops, repro_torch.graph.distributed; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.launch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_collective_computes_nothing_without_a_counter():
    from repro_torch.graph.distributed import make_mesh

    def boom():
        raise AssertionError("counted without a counter")

    cost.count_collective("all-gather", boom)  # no counter: the cost is never asked for
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    x = torch.arange(8 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    with torch.no_grad():
        plain = mesh.all_to_all(x, "model")
    swapped = mesh.all_to_all(x.clone().requires_grad_(True), "model")
    assert torch.equal(plain, swapped) and torch.equal(plain, x.transpose(1, 2))
    with CostCounter() as c:
        mesh.all_to_all(x, "model")
    assert c.coll_calls == [("all-to-all", 4, 4 * 3 * 4)]
    leaf = x.clone().requires_grad_(True)
    with CostCounter() as c:  # the transpose is counted too
        torch.autograd.grad(mesh.all_to_all(leaf, "model").sum(), [leaf])
    assert c.coll_calls == [("all-to-all", 4, 4 * 3 * 4)] * 2
