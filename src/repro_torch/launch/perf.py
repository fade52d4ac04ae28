"""§Perf hillclimb driver: count one cell under a named variant on 'meta' and
report the roofline-term deltas against its baseline (the port of
`repro.launch.perf`).

  PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3.2-3b \
      --shape train_4k --variant fsdp            # → artifacts/torch/perf/
  PYTHONPATH=src python -m repro_torch.launch.perf --arch gin-tu \
      --shape ogb_products --variant halo [--graph-scale 0.05]

Variants are named cfg transforms (`VARIANTS`), the reference's eight on
the port's configs.  "halo" is gin-tu's halo-exchange GIN over the paper's
partition (`models.gnn_dist`): the case is rebuilt, since the batch is the
plan's layout; the plan comes from `graph.halo.build_halo_plan` on a seeded
R-MAT at ogb_products' published |V| and |E| (`--graph-scale` cuts both), P
= 256 engines by default.  The baseline is the cell's record in
`--baseline-dir` (`launch.dryrun`'s), counted afresh where there is none.

`measure_cell` runs a cell on the card at a stated cut (batch, sequence,
layers, graph) on one device, counts that same step on the card and on
'meta', times warm steps with CUDA events and returns the record with a
`measured` entry beside the counted bound.  It needs a CUDA device and
raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, DryrunCase, meta_dcn_params,
                                      meta_lm_params, meta_tree, train_case)
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import DEFAULT_OUT as DRYRUN_DIR
from repro_torch.launch.dryrun import count_case, mesh_name, roofline_of, run_cell

__all__ = ["VARIANTS", "DEFAULT_OUT", "MEASURED_STEPS", "halo_case", "run_gin_halo", "cut_case", "measure_cell",
           "main"]

DEFAULT_OUT = os.path.join("artifacts", "torch", "perf")
MEASURED_STEPS = 5  # warm steps `measure_cell` times
DELTA_KEYS = ("t_compute_s", "t_memory_s", "t_collective_s", "roofline_fraction", "bytes_per_device")


def _replace_rules(cfg, **kw):
    return dataclasses.replace(cfg, rules=dataclasses.replace(cfg.rules, **kw))


def v_fsdp(cfg):
    """ZeRO-3 instead of TP+SP: params over flat ("data","model"), batch over
    everything, zero TP collectives (dense LMs only)."""
    return _replace_rules(cfg, strategy="fsdp")


def v_fsdp_bf16params(cfg):
    """fsdp + bf16 parameter storage (the AdamW moments stay float32)."""
    return dataclasses.replace(_replace_rules(cfg, strategy="fsdp"), param_dtype=torch.bfloat16)


def v_bf16params(cfg):
    return dataclasses.replace(cfg, param_dtype=torch.bfloat16)


def v_no_remat(cfg):
    return dataclasses.replace(cfg, remat=False)


def v_block_skip(cfg):
    """Causal block skipping in the blocked attention path (the plain
    version's; the kernel always skips the tiles above the diagonal)."""
    return dataclasses.replace(cfg, attn_skip_masked_blocks=True)


def v_fsdp_skip(cfg):
    return v_block_skip(v_fsdp(cfg))


def v_fsdp_bf16_skip(cfg):
    return v_block_skip(v_fsdp_bf16params(cfg))


def v_psum_embed(cfg):
    """dcn-v2: the tables row-sharded over "model", each shard's masked
    gather folded over "model" (`recsys.lookup_impl="psum_model"`)."""
    return dataclasses.replace(cfg, lookup_impl="psum_model")


VARIANTS = {
    "fsdp": v_fsdp,
    "fsdp_bf16": v_fsdp_bf16params,
    "bf16params": v_bf16params,
    "no_remat": v_no_remat,
    "block_skip": v_block_skip,
    "fsdp_skip": v_fsdp_skip,
    "fsdp_bf16_skip": v_fsdp_bf16_skip,
    "psum_embed": v_psum_embed,
}


# ------------------------------- the halo GIN ---------------------------------


def ell_to(ell, device):
    """`ell` (and its transpose) with every tensor on `device` (e.g. "meta":
    its shapes only)."""
    from repro_torch.graph.structs import EllBlocks

    return EllBlocks(ell.num_nodes, [r.to(device) for r in ell.rows], [c.to(device) for c in ell.cols],
                     None if ell.weights is None else [w.to(device) for w in ell.weights], list(ell.widths),
                     transpose=None if ell.transpose is None else ell_to(ell.transpose, device))


def halo_case(graph, parts: int) -> DryrunCase:
    """gin-tu at ogb_products' width trained by halo exchange over `parts`
    engines of a 1-D stacked mesh on 'meta': the plan (`build_halo_plan`,
    the powerlaw partition) and its ELL and transpose are built on the host
    from `graph`'s edges; every other leaf is a 'meta' tensor of
    `gnn_dist.batch_specs_halo`'s shapes."""
    from repro_torch.graph.distributed import make_engines_mesh
    from repro_torch.graph.halo import build_halo_plan, plan_sizes
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import gnn_dist
    from repro_torch.train.pytree import tree_leaves

    arch = get_arch("gin-tu")
    cfg = arch.model_config("ogb_products")
    d_feat = GNN_SHAPES["ogb_products"]["d_feat"]
    plan = build_halo_plan(graph.src, graph.dst, graph.num_nodes, parts)
    sizes = plan_sizes(plan)
    mesh = make_engines_mesh(num_engines=parts, device="meta")
    batch = gnn_dist.batch_specs_halo(sizes, d_feat, cfg.d_out)
    batch["send_idx"] = torch.empty(batch["send_idx"].shape, dtype=torch.long, device="meta")  # shard_batch's type
    host = gnn_dist.halo_ell(plan.src_slot, plan.dst_slot, plan.n_local, plan.ext_size, torch.device("cpu"),
                             transpose=True)
    batch["ell"] = ell_to(host, "meta")
    params = meta_tree(gnn_lib.param_shapes(cfg), cfg.param_dtype)
    per_engine = sum(t.numel() * t.element_size() for k, t in batch.items() if k != "ell") / parts
    case = train_case(
        "gin-tu", "ogb_products", lambda p, b: gnn_dist.gin_halo_loss_fn(p, b, cfg, mesh), params, batch,
        mesh=mesh, chips=parts,
        state_bytes=lambda t: float(sum(x.numel() * x.element_size() for x in tree_leaves(t))),
        batch_bytes=per_engine, model_flops=arch.model_flops("ogb_products"),
        note=f"halo plan: {sizes}; graph {graph.name} ({graph.num_nodes} nodes, {graph.num_edges} edges), "
             f"{parts} stacked engines on 'meta', the ELL built on the host", lr=1e-3)
    return case


def run_gin_halo(out_dir: str, *, parts: int = 256, graph_scale: float = 1.0, seed: int = 0) -> dict:
    """The "halo" record of gin-tu × ogb_products: a seeded R-MAT at
    ogb_products' |V| and |E| times `graph_scale` over `parts` engines,
    written to `out_dir`."""
    from repro_torch.graph.generators import rmat
    from repro_torch.obs import span

    sh = GNN_SHAPES["ogb_products"]
    graph = rmat(max(64, int(sh["n_nodes"] * graph_scale)), max(256, int(sh["n_edges"] * graph_scale)), seed=seed,
                 name="rmat")
    with span("launch.count", cat="launch", arch="gin-tu", cell="ogb_products", variant="halo") as sp:
        case = halo_case(graph, parts)
        counter = count_case(case)
    rec = roofline_of(case, counter, "16x16" if parts == 256 else f"{parts}").to_dict()
    rec.update({"status": "ok", "variant": "halo", "parser_v2": True, "count_s": round(sp.duration_s, 2),
                "kernels": dict(counter.kernels), "note": case.note})
    print(f"[gin-tu × ogb_products × halo] t_comp={rec['t_compute_s']:.4g} t_mem={rec['t_memory_s']:.4g} "
          f"t_coll={rec['t_collective_s']:.4g} dominant={rec['dominant']} frac={rec['roofline_fraction']:.4f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"gin-tu__ogb_products__{rec['mesh']}__halo.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


# ------------------------------ measured on the card ------------------------------


def cut_case(arch_id: str, cell: str, cfg_transform=None, *, cut: dict, device, seed: int = 0) -> DryrunCase:
    """The cell's step on one device at `cut`, on `device` ('meta': shapes
    only; else random weights and data from `seed`).  LM training: `cut`
    {"batch", "seq", "layers" (optional)}, the one-device model (MoE
    impl="local"); dcn-v2 serving or training: {"batch"}; a GNN: {"graph":
    a HostGraph}, the
    cell's widths on that graph's edges (GIN by its ELL route, built on the
    host and moved to `device`)."""
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import recsys as rec_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.train.pytree import tree_leaves

    dev = torch.device(device)
    meta = dev.type == "meta"
    arch = get_arch(arch_id)
    rng = np.random.default_rng(seed)

    def data(shape, dtype, fill):
        return torch.empty(shape, dtype=dtype, device=dev) if meta else torch.from_numpy(fill(shape)).to(dev)

    def nbytes(tree) -> float:
        return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))

    if arch.family == "lm":
        kind, _, _ = LM_SHAPES[cell]
        if kind != "train":
            raise ValueError(f"measure_cell runs the LM training cells; {cell!r} is {kind}")
        cfg = arch.model_config()
        if cut.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=int(cut["layers"]))
        cfg = cfg_transform(cfg) if cfg_transform is not None else cfg
        params = meta_lm_params(cfg) if meta else tfm.init_params(cfg, seed, device=dev)
        shape = (int(cut["batch"]), int(cut["seq"]))
        batch = {k: data(shape, torch.int32, lambda s: rng.integers(0, cfg.vocab, s).astype(np.int32))
                 for k in ("tokens", "labels")}
        return train_case(arch_id, cell, lambda p, b: tfm.loss_fn(p, b, cfg), params, batch, mesh=None, chips=1,
                           state_bytes=nbytes, batch_bytes=nbytes(batch), model_flops=_lm_model_flops(cfg, shape),
                           note=f"one device at batch {shape[0]} × {shape[1]}, {cfg.n_layers} layers", lr=3e-4)
    if arch.family == "recsys":
        kind = RECSYS_SHAPES[cell]["kind"]
        if kind == "retrieval":
            raise ValueError(f"measure_cell runs dcn-v2's serving and training cells; {cell!r} is {kind}")
        cfg = arch.model_config()
        cfg = cfg_transform(cfg) if cfg_transform is not None else cfg
        params = meta_dcn_params(cfg) if meta else rec_lib.init_params(cfg, seed, device=dev)
        b = int(cut["batch"])
        batch = {"dense": data((b, cfg.n_dense), torch.float32, lambda s: rng.standard_normal(s, np.float32)),
                 "sparse_ids": data((b, cfg.n_sparse), torch.int32,
                                    lambda s: rng.integers(0, cfg.rows_per_table, s).astype(np.int32)),
                 "labels": data((b,), torch.float32, lambda s: (rng.random(s) < 0.5).astype(np.float32))}
        flops = arch.model_flops(cell) * b / RECSYS_SHAPES[cell]["batch"]
        note = f"one device at batch {b}"
        if kind == "train":
            return train_case(arch_id, cell, lambda p, bb: rec_lib.loss_fn(p, bb, cfg), params, batch, mesh=None,
                               chips=1, state_bytes=nbytes, batch_bytes=nbytes(batch), model_flops=flops, note=note,
                               lr=1e-3)
        return DryrunCase(arch_id, cell, lambda p, bb: rec_lib.forward(p, bb, cfg), (params, batch), None, 1,
                          nbytes(params) + nbytes(batch), flops, note, grad=False)
    # a GNN: the cell's widths on `cut["graph"]`
    g = cut["graph"]
    cfg = arch.model_config(cell)
    cfg = cfg_transform(cfg) if cfg_transform is not None else cfg
    n, e = g.num_nodes, g.num_edges
    params = meta_tree(gnn_lib.param_shapes(cfg), cfg.param_dtype) if meta else \
        gnn_lib.init_params(cfg, seed, device=dev)
    batch = {
        "x": data((n, cfg.d_in), torch.float32, lambda s: rng.standard_normal(s, np.float32)),
        "src": data((e,), torch.int32, lambda s: g.src.astype(np.int32)),
        "dst": data((e,), torch.int32, lambda s: g.dst.astype(np.int32)),
        "edge_mask": data((e,), torch.bool, lambda s: np.ones(s, bool)),
        "node_mask": data((n,), torch.bool, lambda s: np.ones(s, bool)),
        "labels": data((n,), torch.int32, lambda s: rng.integers(0, cfg.d_out, s).astype(np.int32)),
        "train_mask": data((n,), torch.bool, lambda s: np.ones(s, bool)),
    }
    if cfg.kind == "gin" and cfg.reduce_impl == "ell":
        host = {"x": torch.empty((n, 1)), "src": g.src, "dst": g.dst, "edge_mask": np.ones(e, bool)}
        batch["ell"] = ell_to(gnn_lib.batch_ell(host, device="cpu", transpose=True), dev)
    flops = 6.0 * (cfg.num_params * n / max(cfg.d_in, 1) + e * cfg.d_hidden)  # GnnArch.model_flops on this graph
    return train_case(arch_id, cell, lambda p, b: gnn_lib.loss_fn(p, b, cfg), params, batch, mesh=None, chips=1,
                       state_bytes=nbytes, batch_bytes=nbytes({k: v for k, v in batch.items() if k != "ell"}),
                       model_flops=flops, note=f"one device on {g.name} ({n} nodes, {e} edges)", lr=1e-3)


def _lm_model_flops(cfg, shape) -> float:
    return 6.0 * cfg.num_active_params * shape[0] * shape[1]


def measure_cell(arch: str, cell: str, variant: str | None = None, *, cut: dict, seed: int = 0, device=None,
                 smi: str | None = None) -> dict:
    """Run `arch` × `cell` (under `variant`) on the card at `cut` on one
    device: count one step there and the same step on 'meta', then time
    MEASURED_STEPS warm steps with CUDA events.  Returns the record:
    `roofline.Roofline.to_dict()` of the card's count, its `measured` entry
    (`s` the median step, `steps`, `cut`, `card`, `fraction` =
    max(t_compute, t_memory, t_collective) / s, `t_memory_over_measured`),
    `meta` (the 'meta' count) and `counts_equal_meta` (FLOPs by dtype and
    bytes equal exactly)."""
    from repro_torch.device import resolve_device, smi_name_and_power_limit

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"measure_cell times on the card; got device {dev}")
    transform = None if variant is None else VARIANTS[variant]
    meta_case = cut_case(arch, cell, transform, cut=cut, device="meta", seed=seed)
    c_meta = count_case(meta_case)
    case = cut_case(arch, cell, transform, cut=cut, device=dev, seed=seed)
    c_dev = count_case(case)  # the first step, counted on the card
    case.run()  # one more warm step
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(MEASURED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        case.run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    roof = roofline_of(case, c_dev, "1", device="cuda")
    s = float(np.median(times))
    bound = max(roof.t_compute, roof.t_memory, roof.t_collective)
    cut_desc = {k: (f"{v.name} ({v.num_nodes} nodes, {v.num_edges} edges)" if hasattr(v, "num_nodes") else v)
                for k, v in cut.items()}
    roof.measured = {"s": s, "steps": MEASURED_STEPS, "step_s": times, "cut": cut_desc,
                     "card": smi or smi_name_and_power_limit(), "fraction": bound / s,
                     "t_compute_over_measured": roof.t_compute / s, "t_memory_over_measured": roof.t_memory / s}
    rec = roof.to_dict()
    equal = (dict(c_meta.flops_by_dtype) == dict(c_dev.flops_by_dtype) and c_meta.bytes == c_dev.bytes)
    rec.update({"status": "ok", "variant": variant or "baseline", "note": case.note, "kernels": dict(c_dev.kernels),
                "meta": c_meta.totals(), "counts_equal_meta": equal})
    return rec


# ------------------------------------- CLI -------------------------------------


def _baseline(arch: str, cell: str, mesh: str, baseline_dir: str) -> dict:
    """The cell's record in `baseline_dir`, or counted now where there is none."""
    path = os.path.join(baseline_dir, f"{arch}__{cell}__{mesh}.json")
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            return rec
    return run_cell(arch, cell, multi_pod=mesh == "2x16x16", verbose=False)


def print_deltas(base: dict, rec: dict) -> None:
    print("\n--- vs baseline ---")
    for k in DELTA_KEYS:
        b, n = base.get(k), rec.get(k)
        if b and n:
            print(f"  {k:20s} {b:.4g} → {n:.4g}  ({b / n:.2f}× better)" if n < b else f"  {k:20s} {b:.4g} → {n:.4g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="count one cell under a variant and print the deltas")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS) + ["halo"])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--baseline-dir", default=DRYRUN_DIR)
    ap.add_argument("--graph-scale", type=float, default=1.0, help="halo: ogb_products' |V| and |E| times this")
    ap.add_argument("--parts", type=int, default=256, help="halo: engines")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.variant == "halo":
        if (args.arch, args.shape) != ("gin-tu", "ogb_products"):
            ap.error("the halo variant is gin-tu × ogb_products")
        rec = run_gin_halo(args.out, parts=args.parts, graph_scale=args.graph_scale, seed=args.seed)
        print_deltas(_baseline("gin-tu", "ogb_products", "16x16", args.baseline_dir), rec)
        if args.graph_scale != 1.0 or args.parts != 256:
            print(f"  (the halo graph is {args.graph_scale} of ogb_products' size over {args.parts} engines; the "
                  "baseline is the whole cell on 256)")
        return
    multi = args.mesh == "multi"
    rec = run_cell(args.arch, args.shape, multi_pod=multi, cfg_transform=VARIANTS[args.variant])
    rec["variant"] = args.variant
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.arch}__{args.shape}__{rec['mesh']}__{args.variant}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print_deltas(_baseline(args.arch, args.shape, mesh_name(multi), args.baseline_dir), rec)


if __name__ == "__main__":
    main()
