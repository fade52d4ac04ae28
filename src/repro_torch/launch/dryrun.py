"""Dry run: count every (arch × shape × mesh) cell's step on `device="meta"`
(the port of `repro.launch.dryrun`).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \
      --shape train_4k --mesh single           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
      # the full sweep (both meshes), one json a cell, in artifacts/torch/dryrun

Where the reference lowers and compiles each cell with XLA and reads the
compiled program's `cost_analysis`, the port runs the cell's step
(`configs.base.*Arch.dryrun_case`) on "meta" tensors — no memory, no kernel —
under a `obs.cost.CostCounter`, which counts the aten ops the port
issues, the hand-written kernels at their entries and the collectives of
the engine mesh.  The production meshes are `launch.mesh`'s, (16, 16) and
(2, 16, 16), stacked on the one meta device.  The port loops over layers in
Python, so nothing needs the reference's scan correction.

A record has the reference's keys (`roofline.Roofline.to_dict`, `status`,
`parser_v2`, `note`, `raw_costs_scan_body_once` always None), with the
counting's `count_s` in place of `lower_s`/`compile_s`, and the counter's
`kernels` (entries counted).  A cell that raises is written as a `FAIL`
record with its error, and `--all` then exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Roofline
from repro_torch.obs import span
from repro_torch.obs.cost import CostCounter

__all__ = ["DEFAULT_OUT", "mesh_name", "count_case", "roofline_of", "run_cell", "sweep", "main"]

DEFAULT_OUT = os.path.join("artifacts", "torch", "dryrun")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def count_case(case) -> CostCounter:
    """The counts of one run of `case`'s step."""
    with CostCounter() as c:
        case.run()
    return c


def roofline_of(case, counter: CostCounter, mesh: str, *, device: str = "meta") -> Roofline:
    """The cell's roofline: the counted totals over the case's engines (the
    collectives' link bytes are one engine's already)."""
    chips = case.chips
    return Roofline(
        arch=case.arch, cell=case.cell, mesh=mesh, chips=chips,
        hlo_flops=counter.flops / chips, hlo_bytes=counter.bytes / chips,
        coll_bytes=counter.coll_bytes, coll_breakdown={k: v for k, v in counter.coll.items() if v},
        model_flops=case.model_flops, bytes_per_device=case.bytes_per_device,
        flops_by_dtype={d: f / chips for d, f in counter.flops_by_dtype.items()}, device=device,
    )


def run_cell(arch_id: str, cell: str, *, multi_pod: bool, verbose: bool = True, cfg_transform=None) -> dict:
    arch = get_arch(arch_id)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    kw = {"cfg_transform": cfg_transform} if cfg_transform is not None else {}
    with span("launch.count", cat="launch", arch=arch_id, cell=cell) as sp:
        case = arch.dryrun_case(cell, mesh, multi_pod=multi_pod, **kw)
        counter = count_case(case)
    rec = roofline_of(case, counter, mesh_name(multi_pod)).to_dict()
    rec.update({
        "status": "ok",
        "parser_v2": True,  # ring-factor collective accounting
        "count_s": round(sp.duration_s, 2),
        "raw_costs_scan_body_once": None,  # every layer is counted: no scan to correct
        "kernels": dict(counter.kernels),
        "note": case.note,
    })
    if verbose:
        print(f"[{arch_id} × {cell} × {rec['mesh']}] OK (count {sp.duration_s:.1f}s)")
        print(f"  flops={rec['hlo_flops']:.3e} bytes={rec['hlo_bytes']:.3e} coll={rec['coll_bytes']:.3e} "
              f"dominant={rec['dominant']} useful/HLO={rec['useful_flops_ratio']:.3f} "
              f"roofline_frac={rec['roofline_fraction']:.3f}")
    return rec


def _write(out_dir: str, key: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, key + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def sweep(arch_ids, *, out_dir: str | None, meshes=("single", "multi"), resume: bool = True) -> list[dict]:
    records = []
    for arch_id in arch_ids:
        arch = get_arch(arch_id)
        for cell in arch.shape_cells():
            for mesh_kind in meshes:
                multi = mesh_kind == "multi"
                key = f"{arch_id}__{cell}__{mesh_name(multi)}"
                path = os.path.join(out_dir, key + ".json") if out_dir else None
                if resume and path and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") == "ok":
                        records.append(rec)
                        print(f"[{key}] cached")
                        continue
                try:
                    rec = run_cell(arch_id, cell, multi_pod=multi)
                except Exception as e:  # a failing cell is a fault of the port — record it loudly
                    rec = {
                        "arch": arch_id, "cell": cell, "mesh": mesh_name(multi),
                        "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    print(f"[{key}] FAIL: {rec['error']}")
                records.append(rec)
                if out_dir:
                    _write(out_dir, key, rec)
        for cell, reason in arch.skipped_cells().items():
            records.append({"arch": arch_id, "cell": cell, "status": "SKIP", "reason": reason})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description="count every (arch × shape × mesh) cell on 'meta'")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        with span("launch.sweep", cat="launch") as sp:
            recs = sweep(ARCH_IDS, out_dir=args.out, meshes=meshes)
        ok = sum(r["status"] == "ok" for r in recs)
        fail = sum(r["status"] == "FAIL" for r in recs)
        skip = sum(r["status"] == "SKIP" for r in recs)
        print(f"\nDRY-RUN SWEEP: {ok} ok / {fail} fail / {skip} skipped ({sp.duration_s:.1f} s)")
        raise SystemExit(1 if fail else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required unless --all")
    for mesh_kind in meshes:
        rec = run_cell(args.arch, args.shape, multi_pod=mesh_kind == "multi")
        _write(args.out, f"{args.arch}__{args.shape}__{rec['mesh']}", rec)


if __name__ == "__main__":
    main()
