"""Renders sweep results into the port's EXPERIMENTS.md and BENCH_sweep.json.

Every output defaults to a path under `artifacts/torch/` (`DEFAULT_MD`,
`DEFAULT_JSON`, `DEFAULT_SWEEPS_DIR`), so the port never writes over the
reference package's committed report and payloads.  Section names and the
strings `experiments_md_issues` matches (`--grid <name>`, `**N
configurations**`, `scale S; backend`, the `place_batch` count) are those of
the reference's report, so the two reports' tables compare line for line.

§Dry-run, §Roofline and the hillclimb part of §Perf tabulate per-cell cost
records: the port's own, counted from its ops on 'meta'
(`python -m repro_torch.launch.dryrun --all` writes `DEFAULT_DRYRUN_DIR`,
`python -m repro_torch.launch.perf` writes `DEFAULT_PERF_DIR`), in the
reference's keys, so the reference's XLA records render the same way.
Where those directories do not exist the sections render as absent.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

from repro_torch.core.simulator import SimParams
from repro_torch.experiments.sweep import SweepResult, figure_comparisons, metrics_snapshot_for
from repro_torch.obs.metrics import series_value

__all__ = [
    "normalize_dryrun_record",
    "load_dryrun_records",
    "dryrun_table",
    "roofline_table",
    "dryrun_summary",
    "render_experiments_md",
    "save_sweep_artifact",
    "load_sweep_artifacts",
    "write_bench_json",
    "write_outputs",
    "experiments_md_issues",
    "RENDERABLE_SWEEP_GRIDS",
    "DEFAULT_MD",
    "DEFAULT_JSON",
    "DEFAULT_SWEEPS_DIR",
    "DEFAULT_DRYRUN_DIR",
    "DEFAULT_PERF_DIR",
]

OUT_DIR = os.path.join("artifacts", "torch")
DEFAULT_MD = os.path.join(OUT_DIR, "EXPERIMENTS.md")
DEFAULT_JSON = os.path.join(OUT_DIR, "BENCH_sweep.json")
DEFAULT_SWEEPS_DIR = os.path.join(OUT_DIR, "sweeps")
DEFAULT_DRYRUN_DIR = os.path.join(OUT_DIR, "dryrun")
DEFAULT_PERF_DIR = os.path.join(OUT_DIR, "perf")


def fmt_e(x):
    return f"{x:.2e}" if x is not None else "—"


def fmt_gb(x):
    return f"{x/2**30:.2f}" if x is not None else "—"


# --------------------------------------------------------------------------
# §Dry-run / §Roofline artifact tables: per-cell cost records (one JSON a
# cell): the port's, counted by `launch.dryrun`, or the reference's XLA ones,
# rendered alike.
# --------------------------------------------------------------------------


def normalize_dryrun_record(r: dict) -> dict:
    """Records written before the ring-factor parser (parser_v2) counted
    all-reduce link bytes at 1× output size; the ring model is 2·(g−1)/g ≈ 2×
    for the 16/256-way groups in these programs (no reduce-scatter appears in
    any v1 record).  Correct totals + derived terms in place, with the
    interconnect rate and peak FLOP/s those records were costed against."""
    if r.get("status") != "ok" or r.get("parser_v2"):
        return r
    bd = r.get("coll_breakdown") or {}
    extra = bd.get("all-reduce", 0.0)  # add one more output-size worth
    if extra:
        r["coll_bytes"] = r["coll_bytes"] + extra
        bd["all-reduce"] = 2.0 * bd["all-reduce"]
        hw_ici = 50e9
        r["t_collective_s"] = r["coll_bytes"] / hw_ici
        terms = {
            "compute": r["t_compute_s"],
            "memory": r["t_memory_s"],
            "collective": r["t_collective_s"],
        }
        r["dominant"] = max(terms, key=terms.get)
        ideal = r["model_flops"] / (r["chips"] * 197e12)
        r["roofline_fraction"] = ideal / max(terms.values())
    return r


def load_dryrun_records(out_dir: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            recs.append(normalize_dryrun_record(json.load(fh)))
    return recs


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    """§Roofline: per (arch × cell), single-pod mesh only (assignment): the
    port's production (16, 16) engine mesh (`launch.mesh`), named as the
    reference's."""
    rows = [
        "| arch | cell | t_compute (s) | t_memory (s) | t_coll (s) | dominant "
        "| MODEL_FLOPS | useful/HLO | roofline frac | HBM GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        rows.append(
            f"| {r['arch']} | {r['cell']} | {r['t_compute_s']:.4g} | "
            f"{r['t_memory_s']:.4g} | {r['t_collective_s']:.4g} | "
            f"**{r['dominant']}** | {fmt_e(r['model_flops'])} | "
            f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{fmt_gb(r.get('bytes_per_device'))} |"
        )
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    """§Dry-run: every (arch × cell × mesh) status + headline numbers; the
    last column is the compile time of the reference's XLA records, or the
    counting time (`count_s`) of the port's."""
    counted = any("count_s" in r for r in recs) and not any("compile_s" in r for r in recs)
    rows = [
        "| arch | cell | mesh | status | HLO FLOPs/dev | HLO bytes/dev | "
        f"coll bytes/dev | {'count' if counted else 'compile'} (s) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") == "SKIP":
            rows.append(
                f"| {r['arch']} | {r['cell']} | — | SKIP ({r['reason'][:40]}…) | — | — | — | — |"
            )
        elif r.get("status") == "ok":
            rows.append(
                f"| {r['arch']} | {r['cell']} | {r['mesh']} | ok | "
                f"{fmt_e(r['hlo_flops'])} | {fmt_e(r['hlo_bytes'])} | "
                f"{fmt_e(r['coll_bytes'])} | {r.get('compile_s', r.get('count_s', 0)):.0f} |"
            )
        else:
            rows.append(
                f"| {r['arch']} | {r['cell']} | {r.get('mesh','?')} | **FAIL** | — | — | — | — |"
            )
    return "\n".join(rows)


def dryrun_summary(recs: list[dict]) -> str:
    ok = sum(r.get("status") == "ok" for r in recs)
    fail = sum(r.get("status") == "FAIL" for r in recs)
    out = [f"records: {ok} ok, {fail} fail"]
    doms = {}
    for r in recs:
        if r.get("status") == "ok" and r.get("mesh") == "16x16":
            doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    out.append(f"dominant terms (single-pod): {doms}")
    return "\n".join(out)


# --------------------------------------------------------------------------
# Sweep-result sections (Figs. 5/7/8, §Calibration, §Perf)
# --------------------------------------------------------------------------


def _calibration_section(sweep: SweepResult, params: SimParams) -> str:
    lines = [
        "## §Calibration",
        "",
        "### Simulator constants (Table 3 + GRAM engine)",
        "",
        "The paper's cited modelling tools (NVSim-CAM / Destiny / ORION / CACTI)",
        "are not available offline, so per-event energy constants are set to",
        "reproduce the paper's reported baseline energy *composition*; the",
        "speedup and energy **ratios** (Figs. 7/8) are then driven by the",
        "hop-count distribution, exactly as in the paper.  Constants in",
        "`repro_torch.core.simulator.SimParams`:",
        "",
        "| constant | value | provenance |",
        "|---|---|---|",
        f"| NoC frequency | {params.noc_freq_hz:.3g} Hz | Table 3 |",
        f"| packet size | {params.packet_bytes} B | Table 3 |",
        f"| hop latency (T_r + T_w) | {params.hop_latency_s:.3g} s | Table 3 (1 ns/hop @ 1 GHz) |",
        f"| engine frequency | {params.engine_freq_hz:.3g} Hz | §6.1 (100 MHz spatial array) |",
        f"| CAM search | {params.cam_search_cycles:g} cycles | GRAM node config (Fig. 6) |",
        f"| ALU lanes | {params.alu_lanes:g} | one 1024-bit MAT row / 8 B |",
        f"| link+router energy | {params.e_per_hop_per_byte_j:.3g} J/B/hop | calibrated (see above) |",
        f"| router per-packet energy | {params.e_router_per_packet_j:.3g} J | calibrated |",
        f"| CAM search energy | {params.e_cam_search_j:.3g} J | calibrated |",
        f"| ALU op energy | {params.e_alu_per_op_j:.3g} J | calibrated |",
        f"| static power | {params.e_static_w:.3g} W | calibrated |",
        "",
        "§Dry-run, §Roofline and the hillclimb of §Perf tabulate the port's cost"
        " records, counted from its ops on 'meta' (`python -m repro_torch.launch.dryrun"
        " --all`, `python -m repro_torch.launch.perf`).",
        "",
        "### Workload regeneration (Table 2 → offline R-MAT)",
        "",
        f"The four SNAP graphs are regenerated as R-MAT at scale **{sweep.grid.scale:g}**",
        "of the published |V|/|E| (the container is offline).  Skew is",
        "scale-invariant under R-MAT, so the Fig. 4 power-law property — the",
        "input every mapping gain depends on — is preserved and measured here:",
        "",
        "| workload | \\|V\\| | \\|E\\| | α (Eq. 1) | frac(V) for 90% E | top-10% V edge share | Gini | power-law? |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, s in sweep.workload_stats.items():
        lines.append(
            f"| {name} | {s['num_nodes']} | {s['num_edges']} | {s['alpha']:.2f} | "
            f"{s['frac_vertices_for_90pct_edges']:.3f} | "
            f"{s['frac_edges_in_top10pct_vertices']:.3f} | {s['gini']:.3f} | "
            f"{'yes' if s['is_power_law'] else 'no'} |"
        )
    lines.append("")
    lines.append(
        "Fig. 4's observation (≤10 % of vertices cover ≥90 % of edges on the"
        " SNAP originals) holds at this scale: see `frac(V) for 90% E` above."
    )
    return "\n".join(lines)


def _artifact_section(title: str, recs: list[dict], table: str) -> str:
    lines = [f"## {title}", ""]
    if recs:
        lines += [table, ""]
    else:
        lines += [
            "_No cost records found.  This section tabulates the per-cell records",
            f"in `{DEFAULT_DRYRUN_DIR}/`, which `python -m repro_torch.launch.dryrun",
            "--all` writes._",
            "",
        ]
    return "\n".join(lines)


def _perf_section(sweep: SweepResult, perf_recs: list[dict]) -> str:
    # §Perf renders FROM the obs metrics snapshot (the one `run_sweep`
    # attached, or one rebuilt for deserialized results): the stage-time
    # table and the cache line below read `sweep.stage_seconds` /
    # `cache.events` series, so the report and `--metrics-out` can never
    # disagree.  `sweep.timings` stays only as the payload serialization.
    snap = metrics_snapshot_for(sweep)
    gname = sweep.grid.name

    def t_get(stage: str):
        return series_value(snap, "sweep.stage_seconds", grid=gname, stage=stage)

    def cache_ev(kind: str) -> int:
        return int(series_value(snap, "cache.events", grid=gname, kind=kind) or 0)

    ps = sweep.placement_stats or {}
    lines = [
        "## §Perf",
        "",
        "### Batched sweep evaluation (this subsystem's hot path)",
        "",
        f"Grid `{sweep.grid.name}`: **{len(sweep.records)} configurations** — "
        "placement searches run as one stacked swap-delta program "
        f"(`place_batch`: {ps.get('batched_configs', 0)} searched configs, "
        f"{ps.get('greedy_constructed', 0)} of them greedy-constructed by the "
        "stacked argmax-insertion engine, "
        f"{ps.get('torus_constructed', 0)} torus-constructed with no search, "
        "backend "
        f"`{ps.get('backend', sweep.backend)}`) and scoring as one "
        f"`simulate_batch` call (backend `{sweep.backend}`).",
        "",
        "| stage | seconds |",
        "|---|---|",
        f"| graph generation | {t_get('graphs'):.3f} |",
        f"| algorithm tracing (content-hash cached) | {t_get('trace'):.3f} |",
        f"| partition + traffic matrices | {t_get('partition_traffic'):.3f} |",
        f"| **batched placement search ({ps.get('batched_configs', 0)} searched "
        f"+ {ps.get('serial_configs', 0)} constructive configs)** | "
        f"**{t_get('placement'):.4f}** |",
    ]
    if t_get("placement_serial"):
        lines.append(
            f"| serial per-config `place` loop it replaces | {t_get('placement_serial'):.4f} |"
        )
    lines.append(
        f"| **batched evaluation (all configs)** | **{t_get('batched_eval'):.4f}** |"
    )
    if t_get("serial_eval"):
        lines.append(f"| serial per-config `simulate` loop it replaces | {t_get('serial_eval'):.4f} |")
    lines.append(f"| total | {t_get('total'):.2f} |")
    if t_get("placement_serial"):
        pratio = t_get("placement_serial") / max(t_get("placement"), 1e-12)
        worse = ps.get("h_worse_than_serial_configs", 0)
        lines += [
            "",
            f"Batched placement search is **{pratio:.1f}× faster** than the serial"
            " greedy/quad+two_opt loop on this grid, with weighted hops H no worse"
            f" than the serial search for **{ps.get('batched_configs', 0) - worse}/"
            f"{ps.get('batched_configs', 0)}** searched configs"
            f" (max H ratio {ps.get('h_vs_serial_max_ratio', 1.0):.4f};"
            " parity asserted in `tests/test_placement_batch.py`).",
        ]
    if t_get("serial_eval"):
        ratio = t_get("serial_eval") / max(t_get("batched_eval"), 1e-12)
        lines += [
            "",
            f"Batched evaluation is **{ratio:.1f}× faster** than the serial"
            " one-config-at-a-time loop on this grid (identical results to fp"
            " tolerance; see `tests/test_experiments_sweep.py`).",
        ]
    lines += [
        "",
        f"Trace cache: {cache_ev('trace_hits')} hits / {cache_ev('trace_misses')} misses; "
        f"traffic cache: {cache_ev('traffic_hits')} hits / {cache_ev('traffic_misses')} misses "
        "(a repeated sweep re-traces nothing).",
        "",
        "### Dry-run variant hillclimb",
        "",
    ]
    if perf_recs:
        lines += [
            "| arch | cell | variant | t_compute (s) | t_memory (s) | t_coll (s) | roofline frac |",
            "|---|---|---|---|---|---|---|",
        ]
        for r in perf_recs:
            if r.get("status") != "ok":
                continue
            lines.append(
                f"| {r['arch']} | {r['cell']} | {r.get('variant', '?')} | "
                f"{r['t_compute_s']:.4g} | {r['t_memory_s']:.4g} | "
                f"{r['t_collective_s']:.4g} | {r['roofline_fraction']:.3f} |"
            )
    else:
        lines += [
            "_No variant records found.  `python -m repro_torch.launch.perf` writes",
            f"them to `{DEFAULT_PERF_DIR}/`, which is tabulated here._",
        ]
    return "\n".join(lines)


def _fig5_section(comparisons: list[dict]) -> str:
    lines = [
        "## Fig. 5 — Average hop count (proposed vs randomized mapping)",
        "",
        "| workload | topology | hops (proposed) | hops (random) | decrease |",
        "|---|---|---|---|---|",
    ]
    for c in comparisons:
        if c["algorithm"] != "pagerank":
            continue
        lines.append(
            f"| {c['workload']} | {c['topology']} | {c['avg_hops_optimized']:.2f} | "
            f"{c['avg_hops_baseline']:.2f} | {c['hop_decrease']:.2f}× |"
        )
    return "\n".join(lines)


def _fig78_section(comparisons: list[dict]) -> str:
    lines = [
        "## Fig. 7 — Execution-time speedup · Fig. 8 — Energy reduction",
        "",
        "| workload | algorithm | topology | speedup (Fig. 7) | hop decrease | energy ratio (Fig. 8) |",
        "|---|---|---|---|---|---|",
    ]
    speedups, energies = [], []
    for c in comparisons:
        speedups.append(c["speedup"])
        energies.append(c["energy_ratio"])
        lines.append(
            f"| {c['workload']} | {c['algorithm']} | {c['topology']} | "
            f"{c['speedup']:.2f}× | {c['hop_decrease']:.2f}× | {c['energy_ratio']:.2f}× |"
        )
    if speedups:
        lines += [
            "",
            f"Measured speedup range **{min(speedups):.1f}–{max(speedups):.1f}×** "
            "(paper claims 2–5×); energy-efficiency range "
            f"**{min(energies):.1f}–{max(energies):.1f}×** (paper claims 2.7–4×).",
        ]
    return "\n".join(lines)


def _ablation_section(payload: dict) -> str:
    """§Ablation: the full partitioner × placement product (`--grid ablation`)
    — isolating Algorithm 2 (partitioning) from Algorithms 3/4 (placement) by
    crossing the axes instead of pairing them."""
    recs = payload.get("records", [])
    lines = [
        "## §Ablation — partitioner × placement product (`--grid ablation`)",
        "",
        "Speedup/energy are vs the random+random baseline of the same"
        " (workload, parts) cell; `powerlaw+random` isolates the partitioning"
        " gain, `random+auto` the placement gain.",
        "",
        "| workload | parts | partitioner | placement | avg hops | speedup | energy ratio |",
        "|---|---|---|---|---|---|---|",
    ]
    def cell(r):  # baseline must match on every non-scheme axis
        return (r["workload"], r["algorithm"], r["topology"], r["num_parts"])

    base: dict[tuple, dict] = {}
    for r in recs:
        if r["partitioner"] == "random" and r["placement"] == "random":
            base[cell(r)] = r
    for r in sorted(recs, key=lambda r: (cell(r), r["partitioner"], r["placement"])):
        b = base.get(cell(r))
        if b is None or r is b:
            speedup = energy = "1.00×" if r is b else "—"
        else:
            speedup = f"{b['sim_exec_time_s'] / r['sim_exec_time_s']:.2f}×"
            energy = f"{b['sim_energy_j'] / r['sim_energy_j']:.2f}×"
        lines.append(
            f"| {r['workload']} | {r['num_parts']} | {r['partitioner']} | "
            f"{r['placement']} | {r['sim_avg_hops']:.2f} | {speedup} | {energy} |"
        )
    return "\n".join(lines)


def _meshscale_section(payload: dict) -> str:
    """§Mesh scaling: the proposed scheme's gains vs engine count
    (`--grid meshscale`)."""
    comps = payload.get("comparisons", [])
    lines = [
        "## §Mesh scaling — gains vs engine count (`--grid meshscale`)",
        "",
        "| workload | topology | parts | hop decrease | speedup | energy ratio |",
        "|---|---|---|---|---|---|",
    ]
    for c in sorted(comps, key=lambda c: (c["workload"], c["topology"], c["num_parts"])):
        lines.append(
            f"| {c['workload']} | {c['topology']} | {c['num_parts']} | "
            f"{c['hop_decrease']:.2f}× | {c['speedup']:.2f}× | {c['energy_ratio']:.2f}× |"
        )
    if comps:
        lines += [
            "",
            "Gains grow with the mesh (longer random routes to collapse) on"
            " mesh2d and stay flat on the flattened butterfly, matching the"
            " paper's Fig. 7 reasoning.",
        ]
    return "\n".join(lines)


def _torus_section(payload: dict) -> str:
    """§Torus: what the wraparound links buy — torus2d vs mesh2d on the same
    (workload, algorithm, scheme, parts) cell (`--grid torus`), Fig. 7-style
    ratios computed across topologies instead of across schemes."""
    recs = payload.get("records", [])
    cells: dict[tuple, dict[str, dict]] = {}
    for r in recs:
        key = (
            r["workload"],
            r["algorithm"],
            f"{r['partitioner']}+{r['placement']}",
            r["num_parts"],
        )
        cells.setdefault(key, {})[r["topology"]] = r
    lines = [
        "## §Torus — wrap-link gains vs mesh2d (`--grid torus`)",
        "",
        "Same workload, algorithm, scheme and engine count; only the topology"
        " changes (mesh2d → torus2d with exact wraparound X-Y routing, see"
        " `core.noc.Torus2D.route_links`).  Ratios are mesh2d / torus2d, so"
        " > 1× means the wrap links help.  The `powerlaw+greedy` scheme runs"
        " the same search (batched construction + 2-opt) on both topologies;"
        " `powerlaw+auto` is the constructive arm — the torus-native"
        " wrap-aware quad layout (`core.placement.torus_quad_placement`, no"
        " search) on torus2d, quad+2-opt on mesh2d.",
        "",
        "| workload | algorithm | scheme | parts | hops (mesh2d) | hops (torus2d) |"
        " hop gain | speedup | energy gain |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    gains: dict[str, list[float]] = {}
    for key in sorted(cells):
        pair = cells[key]
        mesh, torus = pair.get("mesh2d"), pair.get("torus2d")
        if mesh is None or torus is None:
            continue
        workload, alg, scheme, parts = key
        hop_gain = mesh["sim_avg_hops"] / max(torus["sim_avg_hops"], 1e-12)
        speedup = mesh["sim_exec_time_s"] / max(torus["sim_exec_time_s"], 1e-12)
        energy = mesh["sim_energy_j"] / max(torus["sim_energy_j"], 1e-12)
        gains.setdefault(scheme, []).append(hop_gain)
        lines.append(
            f"| {workload} | {alg} | {scheme} | {parts} | "
            f"{mesh['sim_avg_hops']:.2f} | {torus['sim_avg_hops']:.2f} | "
            f"{hop_gain:.2f}× | {speedup:.2f}× | {energy:.2f}× |"
        )
    if gains:
        per_scheme = "; ".join(
            f"`{s}` {min(g):.2f}–{max(g):.2f}× (mean {sum(g)/len(g):.2f}×)"
            for s, g in sorted(gains.items())
        )
        lines += [
            "",
            f"Hop gain per scheme: {per_scheme}.  Wrap links shorten the"
            " *long* routes, so the randomized baseline (whose routes span the"
            " mesh) gains most, while the optimised mapping — which already"
            " collapses heavy routes to 1–2 hops — gains less: topology and"
            " placement attack the same hop budget from opposite ends,"
            " matching the paper's Fig. 7 topology discussion.",
        ]
    lines += ["", _torus_constructive_subsection(payload)]
    return "\n".join(lines)


def _torus_constructive_subsection(payload: dict) -> str:
    """Constructive-vs-greedy on torus2d: the torus-native layout's H and the
    placement-stage time it saves by skipping the search entirely."""
    recs = payload.get("records", [])
    cells: dict[tuple, dict[str, dict]] = {}
    for r in recs:
        if r["topology"] != "torus2d" or r["partitioner"] != "powerlaw":
            continue
        key = (r["workload"], r["algorithm"], r["num_parts"])
        cells.setdefault(key, {})[r["placement"]] = r
    lines = [
        "### Constructive torus layouts vs greedy+2-opt (torus2d)",
        "",
        "The torus-native wrap-aware quad layout is a pure construction —"
        " seam-spanning hub quads ordered by torus distance"
        " (`torus_quad_placement`) — yet its byte-hops H beats the full"
        " greedy+2-opt search on every torus-grid config:",
        "",
        "| workload | algorithm | parts | byte-hops (greedy+2opt) |"
        " byte-hops (constructive) | H ratio (greedy/constructive) |",
        "|---|---|---|---|---|---|",
    ]
    ratios = []
    for key in sorted(cells):
        pair = cells[key]
        greedy, cons = pair.get("greedy"), pair.get("auto")
        if greedy is None or cons is None:
            continue
        workload, alg, parts = key
        ratio = greedy["sim_byte_hops"] / max(cons["sim_byte_hops"], 1e-12)
        ratios.append(ratio)
        lines.append(
            f"| {workload} | {alg} | {parts} | {fmt_e(greedy['sim_byte_hops'])} | "
            f"{fmt_e(cons['sim_byte_hops'])} | {ratio:.2f}× |"
        )
    ps = payload.get("placement_stats", {})
    if ratios:
        lines += [
            "",
            f"Constructive H ≤ greedy+2-opt H on **{sum(r >= 1.0 - 1e-9 for r in ratios)}"
            f"/{len(ratios)}** torus-grid configs "
            f"(H ratio {min(ratios):.2f}–{max(ratios):.2f}×).",
        ]
    if ps.get("torus_constructed") and ps.get("batched_configs"):
        cons_us = ps.get("construct_s", 0.0) * 1e6 / max(ps["torus_constructed"], 1)
        search_us = ps.get("search_s", 0.0) * 1e6 / max(ps.get("batched_configs", 0), 1)
        lines += [
            "",
            f"Placement-stage cost: **{cons_us:.0f} µs/config** for the"
            f" {ps['torus_constructed']} torus-constructed configs vs"
            f" **{search_us:.0f} µs/config** for the {ps.get('batched_configs', 0)}"
            f" searched configs ({search_us / max(cons_us, 1e-9):.0f}× search-time"
            " saving; split recorded as `placement_stats.construct_s` /"
            " `search_s` in the sweep payload).",
        ]
    return "\n".join(lines)


def _contention_section(payload: dict) -> str:
    """§Contention: the windowed NoC simulator's view (`--grid contention`)
    — hotspot formation, queueing and routing-policy effects the analytic
    peak-link serialization term cannot see (repro_torch.nocsim)."""
    cont = payload.get("contention") or {}
    recs = cont.get("records", [])
    np_ = cont.get("noc_params", {})
    lines = [
        "## §Contention — windowed NoC simulation (`--grid contention`)",
        "",
        "The analytic simulator charges the network one aggregate peak-link"
        " serialization term; the windowed simulator (`repro_torch.nocsim`) replays"
        " the traffic as per-window flit injections over the exact"
        " `route_links` paths and drains per-link occupancy queues"
        f" ({np_.get('windows', '?')} windows, `{np_.get('profile', '?')}`"
        f" injection profile, offered rate {np_.get('inj_rate', '?')}× link"
        " bandwidth).  `contention excess` = contended drain / analytic"
        " serialization term — 1.00× means the aggregate peak already tells"
        " the whole story; > 1× is time-multiplexed hotspot formation the"
        " analytic model misses.",
        "",
    ]
    if not recs:
        lines.append("_No contended records in the stored artifact._")
        return "\n".join(lines)

    def cell(r):
        return (r["workload"], r["algorithm"], r["topology"], r["num_parts"])

    def is_base(r):
        return r["partitioner"] == "random" and r["placement"] == "random"

    cells: dict[tuple, dict[tuple[str, str], dict]] = {}
    for r in recs:
        scheme = "baseline" if is_base(r) else f"{r['partitioner']}+{r['placement']}"
        cells.setdefault(cell(r), {})[(scheme, r["routing"])] = r

    def _schemes(pair, routing):
        """Every non-baseline (scheme, record) of the cell under `routing` —
        a grid growing extra schemes renders extra rows, never drops them."""
        return [
            (s, v) for (s, rt), v in sorted(pair.items()) if s != "baseline" and rt == routing
        ]

    # ---- hotspot relief under dimension-ordered routing ----
    lines += [
        "### Peak-link utilization: baseline vs powerlaw mapping (dor)",
        "",
        "Utilization is each mapping's peak-link load over the SAME"
        " per-cell window — link bandwidth × the baseline's contended drain"
        " time — so the two columns are directly comparable; the paper's"
        " congested-link relief shows as strictly lower powerlaw"
        " utilization on every cell.",
        "",
        "| workload | algorithm | topology | scheme | peak util (baseline) |"
        " peak util (mapped) | relief | excess (baseline) | excess (mapped) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    strictly_lower = total_cells = 0
    for key in sorted(cells):
        pair = cells[key]
        base = pair.get(("baseline", "dor"))
        if base is None:
            continue
        workload, alg, topo, _parts = key
        # bw falls out of the stored scalars: t_serial = peak / bw.
        bw = base["peak_link_load_bytes"] / max(base["t_serialization_s"], 1e-300)
        window = bw * max(base["t_drain_s"], 1e-300)
        util_b = base["peak_link_load_bytes"] / window
        for scheme, prop in _schemes(pair, "dor"):
            util_p = prop["peak_link_load_bytes"] / window
            total_cells += 1
            strictly_lower += util_p < util_b
            lines.append(
                f"| {workload} | {alg} | {topo} | {scheme} | {util_b:.3f} | "
                f"{util_p:.3f} | {util_b / max(util_p, 1e-300):.2f}× | "
                f"{base['contention_excess']:.2f}× | {prop['contention_excess']:.2f}× |"
            )
    lines += [
        "",
        f"Powerlaw peak-link utilization is strictly lower on"
        f" **{strictly_lower}/{total_cells}** cells.",
        "",
        "### Contended win vs routing policy (does the gain survive adaptive routing?)",
        "",
        "Win = baseline contended T_network / powerlaw contended T_network,"
        " per routing arm; `adaptive2` is the minimal-adaptive two-choice"
        " policy (`repro_torch.nocsim.routes`), which rebalances each flow across"
        " the two dimension orders.  `baseline drain relief` is what"
        " adaptive routing alone buys the random mapping.",
        "",
        "| workload | algorithm | topology | scheme | win (dor) | win (adaptive2) |"
        " baseline drain relief (adaptive2) | p99 baseline (dor) | p99 mapped (dor) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(cells):
        pair = cells[key]
        b_dor = pair.get(("baseline", "dor"))
        b_ad = pair.get(("baseline", "adaptive2"))
        if b_dor is None or b_ad is None:
            continue
        workload, alg, topo, _parts = key
        ad_by_scheme = dict(_schemes(pair, "adaptive2"))
        for scheme, p_dor in _schemes(pair, "dor"):
            p_ad = ad_by_scheme.get(scheme)
            if p_ad is None:
                continue
            win_dor = b_dor["t_network_contended_s"] / max(
                p_dor["t_network_contended_s"], 1e-300
            )
            win_ad = b_ad["t_network_contended_s"] / max(
                p_ad["t_network_contended_s"], 1e-300
            )
            relief = b_dor["t_drain_s"] / max(b_ad["t_drain_s"], 1e-300)
            lines.append(
                f"| {workload} | {alg} | {topo} | {scheme} | {win_dor:.2f}× | "
                f"{win_ad:.2f}× | {relief:.2f}× | {fmt_e(b_dor['p99_latency_s'])} | "
                f"{fmt_e(p_dor['p99_latency_s'])} |"
            )
    parity = cont.get("backend_parity_max_rel")
    rtol = cont.get("parity_rtol", 1e-6)
    lines += [
        "",
        "Backends: the torch arm advances every (config × routing arm) through"
        " one stacked float64 window loop on the card"
        " (`repro_torch.nocsim.batch`); the float64 numpy reference produced"
        " the numbers above.  Measured numpy↔torch max relative difference on"
        " contended T_network: "
        + ("not measured (no torch arm)" if parity is None else f"**{parity:.2e}**")
        + f" (contract ≤ {rtol:g}, gated by `repro_torch.experiments.report --check`).",
    ]
    return "\n".join(lines)


def _backpressure_section(payload: dict) -> str:
    """§Backpressure: the closed-loop credit arm (`--grid backpressure`) —
    how much of the open-loop contended win survives once finite per-link
    buffers gate injection (repro_torch.nocsim.credit)."""
    cont = payload.get("contention") or {}
    recs = cont.get("records", [])
    depths = sorted(d for d in (cont.get("buffer_depths") or []))
    lines = [
        "## §Backpressure — closed-loop credit flow control (`--grid backpressure`)",
        "",
        "The open-loop windowed simulator (§Contention) lets every link"
        " absorb whatever its routes inject; the credit arm"
        " (`repro_torch.nocsim.credit`) closes the loop: each link holds a finite"
        " buffer of `buffer_depth` service-windows, a flow injects only"
        " while every link on its route has credits, and gated bytes are"
        " held at the source — so congestion propagates upstream (tree"
        " saturation, head-of-line blocking).  Win = baseline contended"
        " T_network / powerlaw contended T_network on the same cell and"
        " routing arm; `retained` = credit win / open-loop win at the"
        " tightest depth.",
        "",
    ]
    if not recs or not depths:
        lines.append("_No credit-arm records in the stored artifact._")
        return "\n".join(lines)

    def cell(r):
        return (r["workload"], r["topology"], r["num_parts"])

    def is_base(r):
        return r["partitioner"] == "random" and r["placement"] == "random"

    # (cell, scheme?, routing, depth-or-None) → record; depth None = open loop
    by_arm: dict[tuple, dict] = {}
    for r in recs:
        scheme = "baseline" if is_base(r) else f"{r['partitioner']}+{r['placement']}"
        depth = r.get("buffer_depth") if r.get("flow_control") == "credit" else None
        if r.get("flow_control") == "credit" and depth is None:
            continue  # an inf-depth credit record duplicates the open row
        by_arm[(cell(r), scheme, r["routing"], depth)] = r

    def win(c, scheme, routing, depth):
        b = by_arm.get((c, "baseline", routing, depth))
        p = by_arm.get((c, scheme, routing, depth))
        if b is None or p is None:
            return None
        return b["t_network_contended_s"] / max(p["t_network_contended_s"], 1e-300)

    cells = sorted({cell(r) for r in recs})
    schemes = sorted(
        {
            ("baseline" if is_base(r) else f"{r['partitioner']}+{r['placement']}")
            for r in recs
        }
        - {"baseline"}
    )
    head = " | ".join(f"win d={d:g}" for d in depths)
    retained_all: list[float] = []
    open_wins: list[float] = []
    tight_wins: list[float] = []
    for routing in ("dor", "adaptive2"):
        lines += [
            f"### Win retention under backpressure ({routing})",
            "",
            f"| workload | topology | scheme | win (open) | {head} | retained (d={depths[0]:g}) |",
            "|---" * (4 + len(depths) + 1) + "|",
        ]
        for c in cells:
            workload, topo, _parts = c
            for scheme in schemes:
                w_open = win(c, scheme, routing, None)
                if w_open is None:
                    continue
                w_depths = [win(c, scheme, routing, d) for d in depths]
                if any(w is None for w in w_depths):
                    continue
                retained = w_depths[0] / max(w_open, 1e-300)
                retained_all.append(retained)
                open_wins.append(w_open)
                tight_wins.append(w_depths[0])
                cols = " | ".join(f"{w:.2f}×" for w in w_depths)
                lines.append(
                    f"| {workload} | {topo} | {scheme} | {w_open:.2f}× | {cols} | "
                    f"{retained:.0%} |"
                )
        lines.append("")
    if retained_all:
        lines += [
            f"Across all cells and routing arms the open-loop contended win is"
            f" **{min(open_wins):.2f}–{max(open_wins):.2f}×**; at the tightest"
            f" buffer depth (d={depths[0]:g} service-windows) the credit arm"
            f" retains **{min(tight_wins):.2f}–{max(tight_wins):.2f}×** —"
            f" a retained-win ratio of"
            f" **{min(retained_all):.0%}–{max(retained_all):.0%}** of the"
            " open-loop win.  The mapping's advantage is structural (fewer"
            " contended links), not an artifact of unbounded queues.",
            "",
        ]
    inf_np = cont.get("credit_inf_numpy_max_abs")
    inf_torch = cont.get("credit_inf_torch_max_rel")
    parity = cont.get("backend_parity_max_rel")
    rtol = cont.get("parity_rtol", 1e-6)
    lines += [
        "Contracts (gated by `repro_torch.experiments.report --check`): the"
        " infinite-credit run reproduces the open-loop arm — numpy max |Δ|"
        " T_network "
        + ("not measured" if inf_np is None else f"**{inf_np:g}** (must be 0)")
        + ", torch max rel "
        + ("not measured (no torch arm)" if inf_torch is None else f"**{inf_torch:.2e}**")
        + "; numpy↔torch parity over every (config × arm × depth): "
        + ("not measured (no torch arm)" if parity is None else f"**{parity:.2e}**")
        + f" (≤ {rtol:g}).",
    ]
    return "\n".join(lines)


def _scale_section(payload: dict) -> str:
    """§Scale: the sparse-first pipeline at the published workload sizes
    (`--grid scale`) — per-scale mapping gains plus the pipeline's stage
    times and running peak RSS (sweep.peak_rss_mb samples)."""
    recs = payload.get("records", [])
    comps = payload.get("comparisons", [])
    grid = payload.get("grid", {})
    lines = [
        "## §Scale — published workload sizes via the sparse pipeline (`--grid scale`)",
        "",
        "Traffic extraction streams per-edge blocks"
        f" (edge_block = {grid.get('traffic_edge_block', '?')}) through the"
        " integer-exact COO accumulator and the content-hashed shard cache"
        " (`repro_torch.experiments.cache`), so transients stay O(block) while the"
        " graph grows toward Table-2 size — the dense-parity property tests"
        " (`tests/test_sparse_traffic.py`) pin the streamed results to the"
        " dense reference bit-for-bit.",
        "",
        "| scale | \\|V\\| | \\|E\\| | scheme | iters | avg hops | hop decrease | speedup | energy ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    size_of = {
        (r["scale"], r["partitioner"], r["placement"]): r for r in recs
    }
    for c in sorted(comps, key=lambda c: (c.get("scale", 0.0), c["scheme"])):
        pt, pl = c["scheme"].split("+", 1)
        r = size_of.get((c.get("scale"), pt, pl))
        if r is None:
            continue
        lines.append(
            f"| {c['scale']:g} | {r['num_nodes']} | {r['num_edges']} | {c['scheme']} | "
            f"{r['num_iterations']} | {c['avg_hops_optimized']:.2f} | "
            f"{c['hop_decrease']:.2f}× | {c['speedup']:.2f}× | {c['energy_ratio']:.2f}× |"
        )
    t = payload.get("timings", {})
    mem = payload.get("memory", {})
    lines += [
        "",
        "### Pipeline cost (all scales in one sweep)",
        "",
        "Peak RSS is the process high-water mark sampled *after* each stage"
        " (monotone), so each row reads \"the pipeline up to and including"
        " this stage fit in this much memory\".",
        "",
        "| stage | seconds | peak RSS through stage (MiB) |",
        "|---|---|---|",
    ]
    stage_rows = [
        ("graph generation", "graphs_s", "graphs_mb"),
        ("algorithm tracing", "trace_s", "trace_mb"),
        ("partition + streamed traffic", "partition_traffic_s", "partition_traffic_mb"),
        ("batched placement search", "placement_s", "placement_mb"),
        ("batched evaluation", "batched_eval_s", "batched_eval_mb"),
        ("total", "total_s", "final_mb"),
    ]
    for label, tk, mk in stage_rows:
        tv = t.get(tk)
        mv = mem.get(mk)
        lines.append(
            f"| {label} | {tv:.2f} |" if tv is not None else f"| {label} | — |"
        )
        lines[-1] += f" {mv:.0f} |" if mv is not None else " — |"
    return "\n".join(lines)


def _resilience_section(payload: dict) -> str:
    """§Resilience: graceful degradation under injected fabric faults
    (`--grid faults`) — how much of the proposed mapping's contended win
    survives dead links, plus the tile-death evacuation/repair ledger
    (repro_torch.faults)."""
    fl = payload.get("faults") or {}
    recs = fl.get("records", [])
    repair = fl.get("repair", [])
    np_ = fl.get("noc_params", {})
    lines = [
        "## §Resilience — graceful degradation under fabric faults (`--grid faults`)",
        "",
        "Each cell replays the contended windowed simulation on a fabric"
        " where a seeded, connectivity-preserving sample of links dies at"
        f" window {fl.get('fail_window', '?')} of {np_.get('windows', '?')}:"
        " pristine dimension-ordered routes before the event, detour routes"
        " (alternative dimension orders, then shortest surviving path) plus"
        " backlog redistribution after it, against the PRISTINE capacity"
        " budget.  Win = baseline contended T_network / proposed contended"
        " T_network on the SAME broken fabric; retention = win(rate) /"
        " win(0) per cell.",
        "",
    ]
    if not recs:
        lines.append("_No resilience records in the stored artifact._")
        return "\n".join(lines)
    win0 = {
        (r["workload"], r["algorithm"], r["topology"], r["num_parts"]): r["win"]
        for r in recs
        if r["fault_rate"] == 0.0
    }
    lines += [
        "### Win retention vs fault rate",
        "",
        "| workload | algorithm | topology | fault rate | dead links |"
        " detoured flows | route stretch | win | retention |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    retained = total = 0
    for r in sorted(
        recs,
        key=lambda r: (r["workload"], r["algorithm"], r["topology"], r["num_parts"], r["fault_rate"]),
    ):
        w0 = win0.get((r["workload"], r["algorithm"], r["topology"], r["num_parts"]))
        ret = r["win"] / w0 if w0 else float("nan")
        if r["fault_rate"] > 0.0 and w0:
            total += 1
            retained += r["win"] > 1.0
        lines.append(
            f"| {r['workload']} | {r['algorithm']} | {r['topology']} | "
            f"{r['fault_rate']:g} | {r['num_dead_links']}/{r['num_links']} | "
            f"{r['num_detoured_flows']} | {r['detour_stretch']:.3f}× | "
            f"{r['win']:.2f}× | {ret:.2f} |"
        )
    lines += [
        "",
        f"The proposed mapping still beats the baseline (win > 1×) on"
        f" **{retained}/{total}** faulted cells.",
    ]
    if repair:
        lines += [
            "",
            "### Tile-death evacuation and bounded repair (fault-free cells)",
            "",
            "Dead tiles evict their shards onto an over-provisioned router"
            " grid (greedy evacuation, heaviest traffic first); `budget`"
            " bounds the best-move repair descent that follows"
            " (`repro_torch.faults.repair`, stacked engine"
            " `placement_batch.repair_batch` bit-checked every run)."
            "  H is weighted hops under surviving-fabric distances;"
            " recovery 1.0 = the budget bought everything a full re-place"
            " would (can exceed 1 when bounded repair beats from-scratch).",
            "",
            "| workload | topology | routers | dead tiles | displaced |"
            " budget | steps | H evacuated | H repaired | H full re-place |"
            " recovery |",
            "|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in sorted(
            repair, key=lambda r: (r["workload"], r["topology"], r["num_parts"], r["budget"])
        ):
            kx, ky = r["router_grid"]
            lines.append(
                f"| {r['workload']} | {r['topology']} | {kx}×{ky} | "
                f"{r['num_dead_tiles']} | {r['num_displaced']} | {r['budget']} | "
                f"{r['steps_used']} | {r['h_evacuated']:.0f} | "
                f"{r['h_repaired']:.0f} | {r['h_full']:.0f} | "
                f"{r['recovery_frac']:.2f} |"
            )
    parity = fl.get("backend_parity_max_rel")
    rtol = fl.get("parity_rtol", 1e-6)
    lines += [
        "",
        "Backends: the degraded replay reuses the pristine arm's window"
        " steppers verbatim as a two-segment run (numpy float64 reference,"
        " stacked float64 torch window loop on the card), with the boundary"
        " backlog redistribution shared.  Measured numpy↔torch max relative"
        " difference on contended T_network under faults: "
        + ("not measured (no torch arm)" if parity is None else f"**{parity:.2e}**")
        + f" (contract ≤ {rtol:g}, gated by `repro_torch.experiments.report --check`).",
    ]
    quarantined = fl.get("quarantined") or {}
    if quarantined:
        lines += [
            "",
            f"**{len(quarantined)} unit(s) quarantined** (errored or timed"
            " out; retried on the next `--resume` run): "
            + ", ".join(sorted(quarantined)),
        ]
    return "\n".join(lines)


_EXTRA_SWEEP_SECTIONS = {
    "ablation": _ablation_section,
    "meshscale": _meshscale_section,
    "torus": _torus_section,
    "contention": _contention_section,
    "backpressure": _backpressure_section,
    "scale": _scale_section,
    "faults": _resilience_section,
}
# Grids whose artifacts the paper render folds in — the only ones worth
# persisting under the sweeps directory (the paper grid's payload already
# lives in BENCH_sweep.json).
RENDERABLE_SWEEP_GRIDS = tuple(_EXTRA_SWEEP_SECTIONS)


def render_experiments_md(
    sweep: SweepResult,
    *,
    dryrun_records: list[dict] | None = None,
    perf_records: list[dict] | None = None,
    extra_sweeps: dict[str, dict] | None = None,
    params: SimParams = SimParams(),
) -> str:
    dryrun_records = dryrun_records or []
    perf_records = perf_records or []
    extra_sweeps = extra_sweeps or {}
    comparisons = figure_comparisons(sweep.records)
    g = sweep.grid
    parts = [
        "# EXPERIMENTS",
        "",
        "_Generated by `python -m repro_torch.experiments.run --grid "
        f"{g.name}` — edit that generator, not this file._",
        "",
        "Evidence record for the reproduction of **“Efficient On-Chip"
        " Communication for Parallel Graph-Analytics on Spatial Architectures”**"
        " (arXiv 2108.11521).  Grid: "
        f"{len(sweep.records)} configurations = "
        f"{len(g.workloads)} workloads × {len(g.algorithms)} algorithms × "
        f"{len(g.schemes())} schemes × {len(g.topologies)} topologies × "
        f"{len(g.parts)} mesh size(s); scale {g.scale:g}; backend `{sweep.backend}`.",
        "",
        _calibration_section(sweep, params),
        "",
        _artifact_section(
            "§Dry-run",
            dryrun_records,
            dryrun_table(dryrun_records),
        ),
        _artifact_section(
            "§Roofline",
            [r for r in dryrun_records if r.get("status") == "ok"],
            roofline_table(dryrun_records),
        ),
        _perf_section(sweep, perf_records),
        "",
        _fig5_section(comparisons),
        "",
        _fig78_section(comparisons),
    ]
    for name, renderer in _EXTRA_SWEEP_SECTIONS.items():
        payload = extra_sweeps.get(name)
        if payload:
            parts += ["", renderer(payload)]
    parts += [
        "",
        "## Reproduce",
        "",
        "```bash",
        "export PYTHONPATH=src",
        f"python -m repro_torch.experiments.run --grid {g.name}   # this file + BENCH_sweep.json"
        " (on the card; add --device cpu on a host without one)",
    ]
    # One refresh line per registered secondary section, so footer and
    # renderer registry cannot drift.
    parts += [
        f"python -m repro_torch.experiments.run --grid {name}   "
        f"# refreshes {DEFAULT_SWEEPS_DIR}/{name}.json"
        for name in _EXTRA_SWEEP_SECTIONS
    ]
    parts += [
        "python -m repro_torch.experiments.report --check   # this file against its payloads",
        "python -m pytest -q tests/test_torch_*.py          # the port against the reference package",
        "```",
        "",
    ]
    return "\n".join(parts)


def save_sweep_artifact(sweep: SweepResult, sweeps_dir: str = DEFAULT_SWEEPS_DIR) -> str:
    """Persist one grid's full result payload as `<sweeps_dir>/<grid>.json`
    so later `--grid paper` report runs can render it (§Ablation, §Mesh
    scaling, …) without re-running the sweep."""
    os.makedirs(sweeps_dir, exist_ok=True)
    path = os.path.join(sweeps_dir, f"{sweep.grid.name}.json")
    with open(path, "w") as f:
        json.dump(sweep.to_dict(), f, indent=1)
    return path


def load_sweep_artifacts(sweeps_dir: str = DEFAULT_SWEEPS_DIR) -> dict[str, dict]:
    """name → payload for every stored sweep artifact (empty if none)."""
    out = {}
    for f in sorted(glob.glob(os.path.join(sweeps_dir, "*.json"))):
        with open(f) as fh:
            out[os.path.splitext(os.path.basename(f))[0]] = json.load(fh)
    return out


def write_outputs(
    sweep: SweepResult,
    *,
    md_path: str = DEFAULT_MD,
    json_path: str = DEFAULT_JSON,
    dryrun_dir: str = DEFAULT_DRYRUN_DIR,
    perf_dir: str = DEFAULT_PERF_DIR,
    sweeps_dir: str = DEFAULT_SWEEPS_DIR,
    params: SimParams = SimParams(),
) -> tuple[str, str]:
    """Write EXPERIMENTS.md + BENCH_sweep.json (making their directories);
    returns the two paths."""
    dryrun_records = load_dryrun_records(dryrun_dir) if os.path.isdir(dryrun_dir) else []
    perf_records = load_dryrun_records(perf_dir) if os.path.isdir(perf_dir) else []
    extra = load_sweep_artifacts(sweeps_dir) if os.path.isdir(sweeps_dir) else {}
    extra[sweep.grid.name] = sweep.to_dict()  # current run wins over stale disk
    md = render_experiments_md(
        sweep,
        dryrun_records=dryrun_records,
        perf_records=perf_records,
        extra_sweeps=extra,
        params=params,
    )
    os.makedirs(os.path.dirname(md_path) or ".", exist_ok=True)
    with open(md_path, "w") as f:
        f.write(md)
    write_bench_json(sweep, json_path, params=params)
    return md_path, json_path


def write_bench_json(sweep: SweepResult, json_path: str, *, params: SimParams = SimParams()) -> str:
    """The machine-readable half of `write_outputs` on its own (for runs that
    want a payload without touching EXPERIMENTS.md)."""
    payload = sweep.to_dict()
    payload["sim_params"] = dataclasses.asdict(params)
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=1)
    return json_path


# --------------------------------------------------------------------------
# Freshness: is a written EXPERIMENTS.md stale vs the payloads beside it?
# --------------------------------------------------------------------------


def experiments_md_issues(
    md_path: str = DEFAULT_MD,
    json_path: str = DEFAULT_JSON,
    sweeps_dir: str = DEFAULT_SWEEPS_DIR,
) -> list[str]:
    """Cheap staleness audit of a written report against the machine-readable
    payloads beside it — no sweep is run.  Returns a list of
    human-readable problems (empty = fresh).  Catches the two ways the
    report drifts: a sweep artifact stored under `sweeps_dir` whose section
    was never rendered (run `--grid <name>` but not the follow-up
    `--grid paper`), and a BENCH_sweep.json regenerated without rewriting
    EXPERIMENTS.md (or vice versa).  A payload whose torch arm is missing
    (parity `None`) is stale too: the port's sweeps measure it on every
    contention, backpressure and faults run with `--backend torch`."""
    issues: list[str] = []
    if not os.path.exists(md_path):
        return [f"{md_path} missing — run `python -m repro_torch.experiments.run --grid paper`"]
    with open(md_path) as fh:
        text = fh.read()
    stored = (
        sorted(
            os.path.splitext(os.path.basename(f))[0]
            for f in glob.glob(os.path.join(sweeps_dir, "*.json"))
        )
        if os.path.isdir(sweeps_dir)
        else []
    )
    for name in stored:
        if name in _EXTRA_SWEEP_SECTIONS and f"`--grid {name}`" not in text:
            issues.append(
                f"{md_path} lacks the section for {sweeps_dir}/{name}.json — "
                "re-run `python -m repro_torch.experiments.run --grid paper` to render it"
            )
    # ...and the reverse direction: a rendered section whose backing artifact
    # is gone means the report can no longer be reproduced from the stored
    # payloads (e.g. the artifact was deleted or never written there).
    for name in _EXTRA_SWEEP_SECTIONS:
        if f"`--grid {name}`" in text and name not in stored:
            issues.append(
                f"{md_path} renders a §{name} section but {sweeps_dir}/{name}.json "
                "is missing — restore the artifact or re-run `--grid paper` without it"
            )
    # §Contention carries its own machine-checkable contract: the stored
    # artifact must hold the contended records AND an in-tolerance numpy↔torch
    # parity measurement (the acceptance gate for the windowed simulator's
    # dual backends) — a contention.json written without the nocsim pass, or
    # with drifted backends, fails verify instead of rendering silently.
    if "contention" in stored:
        cpath = os.path.join(sweeps_dir, "contention.json")
        with open(cpath) as fh:
            cont = (json.load(fh) or {}).get("contention") or {}
        if not cont.get("records"):
            issues.append(
                f"{cpath} has no contended records — re-run "
                "`python -m repro_torch.experiments.run --grid contention`"
            )
        else:
            parity = cont.get("backend_parity_max_rel")
            rtol = cont.get("parity_rtol", 1e-6)
            if parity is None:
                issues.append(
                    f"{cpath} records no numpy↔torch parity measurement — re-run "
                    "`--grid contention` on a CUDA device (or name one with `--device`)"
                )
            elif parity > rtol:
                issues.append(
                    f"{cpath} backend parity {parity:.2e} exceeds the {rtol:g} "
                    "contract — the nocsim numpy and torch steppers drifted"
                )
    # §Backpressure's contract: the stored artifact must hold the credit
    # arm (flow_control="credit" records over >= 2 buffer depths, including a
    # Torus3D row), an in-tolerance numpy↔torch parity measurement spanning the
    # credit arm, and the infinite-credit audit — numpy bit-identical to the
    # open-loop arm (max |Δ| exactly 0.0) and torch within the parity contract.
    # A backpressure.json from an open-loop-only run, or with a drifted
    # credit stepper, fails verify instead of rendering silently.
    if "backpressure" in stored:
        bpath = os.path.join(sweeps_dir, "backpressure.json")
        with open(bpath) as fh:
            bp = (json.load(fh) or {}).get("contention") or {}
        brecs = bp.get("records", [])
        credit = [r for r in brecs if r.get("flow_control") == "credit"]
        if not credit:
            issues.append(
                f"{bpath} has no credit-arm records — re-run "
                "`python -m repro_torch.experiments.run --grid backpressure`"
            )
        else:
            bdepths = {
                r.get("buffer_depth")
                for r in credit
                if r.get("buffer_depth") is not None
            }
            if len(bdepths) < 2:
                issues.append(
                    f"{bpath} covers {len(bdepths)} buffer depth(s) — the "
                    "backpressure grid needs a >= 2-point buffer_depth axis"
                )
            if not any(r.get("topology") == "torus3d" for r in credit):
                issues.append(
                    f"{bpath} has no torus3d credit row — re-run "
                    "`--grid backpressure` with the full topology axis"
                )
            bparity = bp.get("backend_parity_max_rel")
            brtol = bp.get("parity_rtol", 1e-6)
            if bparity is None:
                issues.append(
                    f"{bpath} records no numpy↔torch parity for the credit arm — "
                    "re-run `--grid backpressure` on a CUDA device (or name one with `--device`)"
                )
            elif bparity > brtol:
                issues.append(
                    f"{bpath} credit-arm backend parity {bparity:.2e} exceeds "
                    f"the {brtol:g} contract — the credit steppers drifted"
                )
            inf_np = bp.get("credit_inf_numpy_max_abs")
            if inf_np is None or inf_np != 0.0:
                issues.append(
                    f"{bpath} infinite-credit numpy audit is "
                    f"{'missing' if inf_np is None else f'{inf_np:g}'} — the "
                    "credit arm at buffer_depth=inf must reproduce the "
                    "open-loop arm bit-identically"
                )
            inf_torch = bp.get("credit_inf_torch_max_rel")
            if inf_torch is None:
                issues.append(
                    f"{bpath} records no infinite-credit torch audit — re-run "
                    "`--grid backpressure` on a CUDA device (or name one with `--device`)"
                )
            elif inf_torch > brtol:
                issues.append(
                    f"{bpath} infinite-credit torch deviation {inf_torch:.2e} "
                    f"exceeds the {brtol:g} contract vs the open-loop arm"
                )
    # §Resilience's contract: the stored faults artifact must cover the
    # headline fault rates (1/2/5/10% dead links), carry an in-tolerance
    # numpy↔torch parity measurement for the degraded arm, and hold no
    # quarantined units — a payload from a scoped-down, numpy-only, or
    # partially-failed run fails verify instead of rendering silently.
    if "faults" in stored:
        fpath = os.path.join(sweeps_dir, "faults.json")
        with open(fpath) as fh:
            fl = (json.load(fh) or {}).get("faults") or {}
        frecs = fl.get("records", [])
        if not frecs:
            issues.append(
                f"{fpath} has no resilience records — re-run "
                "`python -m repro_torch.experiments.run --grid faults`"
            )
        else:
            rates = {r.get("fault_rate") for r in frecs}
            missing = sorted({0.01, 0.02, 0.05, 0.10} - rates)
            if missing:
                issues.append(
                    f"{fpath} lacks records at fault rate(s) {missing} — "
                    "re-run `--grid faults` with the full rate axis"
                )
            fparity = fl.get("backend_parity_max_rel")
            frtol = fl.get("parity_rtol", 1e-6)
            if fparity is None:
                issues.append(
                    f"{fpath} records no numpy↔torch parity for the degraded arm — "
                    "re-run `--grid faults --backend torch` on a CUDA device"
                    " (or name one with `--device`)"
                )
            elif fparity > frtol:
                issues.append(
                    f"{fpath} degraded-arm backend parity {fparity:.2e} exceeds "
                    f"the {frtol:g} contract — the two-segment steppers drifted"
                )
            if fl.get("quarantined"):
                issues.append(
                    f"{fpath} carries quarantined units "
                    f"({sorted(fl['quarantined'])}) — re-run `--grid faults --resume`"
                )
    # §Scale's own contract: the stored artifact must actually cover the
    # published-size target (a cell at scale ≥ 0.1) and carry the per-stage
    # peak-RSS samples the section's memory column renders — a scale.json
    # from a scoped-down or pre-instrumentation run fails verify instead of
    # rendering a hollow section.
    if "scale" in stored:
        spath = os.path.join(sweeps_dir, "scale.json")
        with open(spath) as fh:
            spayload = json.load(fh) or {}
        srecs = spayload.get("records", [])
        if not srecs or max(r.get("scale", 0.0) for r in srecs) < 0.1:
            issues.append(
                f"{spath} has no record at workload scale >= 0.1 — re-run "
                "`python -m repro_torch.experiments.run --grid scale`"
            )
        if not (spayload.get("memory") or {}).get("final_mb"):
            issues.append(
                f"{spath} lacks the per-stage peak-RSS samples (memory.final_mb) — "
                "re-run `python -m repro_torch.experiments.run --grid scale`"
            )
    if not os.path.exists(json_path):
        issues.append(f"{json_path} missing — run `python -m repro_torch.experiments.run --grid paper`")
        return issues
    with open(json_path) as fh:
        payload = json.load(fh)
    # Markers replicate the report's exact surrounding text so a shorter
    # number can never match inside a longer one ("8 configurations" must
    # not pass against a report saying "48 configurations").
    markers = {
        "config count": f"**{len(payload.get('records', []))} configurations**",
        "workload scale": f"scale {payload['grid']['scale']:g}; backend",
        "searched-config count": (
            f"`place_batch`: {payload.get('placement_stats', {}).get('batched_configs', 0)}"
            " searched configs"
        ),
    }
    for what, marker in markers.items():
        if marker not in text:
            issues.append(
                f"{md_path} disagrees with {json_path} on the {what} "
                f"(expected {marker!r} in the report) — the two were written "
                "by different runs; re-run `--grid paper`"
            )
    return issues


def main(argv: list[str] | None = None) -> int:
    """`python -m repro_torch.experiments.report --check`: the freshness audit as a
    CI gate (0 = fresh, 1 = stale)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.experiments.report",
        description="audit the port's EXPERIMENTS.md freshness against its payloads",
    )
    ap.add_argument("--check", action="store_true", required=True)
    ap.add_argument("--md", default=DEFAULT_MD)
    ap.add_argument("--json", default=DEFAULT_JSON)
    ap.add_argument("--sweeps-dir", default=DEFAULT_SWEEPS_DIR)
    args = ap.parse_args(argv)
    issues = experiments_md_issues(args.md, args.json, args.sweeps_dir)
    for issue in issues:
        print(f"STALE: {issue}")
    if not issues:
        print(f"{args.md} is fresh vs {args.json} and {args.sweeps_dir}/")
    return 1 if issues else 0


if __name__ == "__main__":
    raise SystemExit(main())
