#!/usr/bin/env bash
# The PyTorch port's verification entry point, the counterpart of
# scripts/verify.sh (which verifies the JAX package and stays as it is):
#
#   bash scripts/verify_torch.sh [cpu|cuda]     (default: cuda, the card)
#
# Every arm runs through `repro_torch` only, on the device given:
#   * the port's tests (tests/test_torch_*.py) — in cpu mode only: they hold
#     the port against the JAX package, which the card's machine does not
#     have;
#   * the sweep CLI's paper grid, then the port's EXPERIMENTS.md freshness
#     audit (`python -m repro_torch.experiments.report --check`);
#   * the port's parity/determinism lint and parity-table freshness gate;
#   * a 3-config mini sweep with verify.sh's assertions;
#   * the observability arm: recording on ≡ off byte for byte, the trace and
#     metrics valid against schemas/*.json, the < 5 % overhead gate;
#   * the resilience arm: the minifaults grid, then kill -9 mid-sweep and a
#     journaled --resume that must reproduce the artifact byte for byte;
#   * the backpressure arm: the minicredit grid (payload keys say `torch`);
#   * the dry run of every cell on 'meta' into artifacts/torch/dryrun.
# It ends with VERIFY TORCH OK; any failing arm stops it with a non-zero exit.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

device="${1:-cuda}"
case "$device" in
    cpu|cuda) ;;
    *) echo "usage: $0 [cpu|cuda] (got '$device')" >&2; exit 2 ;;
esac
if [[ "$device" == "cuda" ]] && ! python -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"; then
    echo "verify_torch: no CUDA device; run '$0 cpu' on the host" >&2
    exit 1
fi
echo "== device: $device =="

echo "== the port's tests =="
if [[ "$device" == "cpu" ]]; then
    # they compare the port with the JAX package on the same seeded inputs
    if python -c "import xdist" 2>/dev/null; then
        JAX_PLATFORMS=cpu python -m pytest -q -p xdist -n 4 --dist loadfile \
            tests/test_torch_*.py
    else
        JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_*.py
    fi
else
    echo "cuda mode: the port's tests need the JAX package, which the card's machine lacks;"
    echo "run '$0 cpu' on a host for them (the card's own tests: pytest -m gpu tests/test_torch_gpu_kernels.py)"
fi

echo "== the paper grid, then the port's EXPERIMENTS.md freshness audit =="
python -m repro_torch.experiments.run --grid paper --device "$device" -q
python -m repro_torch.experiments.report --check

echo "== parity/determinism contract lint (the port's rules) =="
python -m repro_torch.analysis.lint src/repro_torch --check-baseline \
    --baseline artifacts/torch_lint_baseline.json
python -m repro_torch.analysis.parity_table --check

echo "== mini sweep (3 configs) =="
out="$(mktemp -d)"
python -m repro_torch.experiments.run --grid mini --device "$device" \
    --md "$out/EXPERIMENTS.mini.md" --json "$out/BENCH_sweep.mini.json" \
    --cache-dir "$out/cache" --sweeps-dir "$out/sweeps"
test -s "$out/EXPERIMENTS.mini.md"
test -s "$out/BENCH_sweep.mini.json"
python - "$out/BENCH_sweep.mini.json" <<'EOF'
import json, sys
payload = json.load(open(sys.argv[1]))
assert payload["records"], "mini sweep produced no records"
assert payload["comparisons"], "mini sweep produced no comparisons"
for c in payload["comparisons"]:
    assert c["speedup"] > 1.0 and c["hop_decrease"] > 1.0, c
ps = payload["placement_stats"]
assert ps["batched_configs"] >= 2, f"batched placement path not exercised: {ps}"
assert ps["greedy_constructed"] >= 1, f"batched greedy construction not exercised: {ps}"
assert ps["h_worse_than_serial_configs"] == 0, f"batched H worse than serial: {ps}"
assert any(
    "2opt[batch]" in r["placement_method"] for r in payload["records"]
), "no record carries the batched-engine method tag"
assert any(
    r["placement_method"] == "greedy+2opt[batch]" for r in payload["records"]
), "no record went through the stacked greedy construction"
c = payload["comparisons"][0]
print(f"mini sweep ok: speedup={c['speedup']:.2f}x hop_decrease={c['hop_decrease']:.2f}x "
      f"placement batched={ps['batched_configs']} greedy-constructed="
      f"{ps['greedy_constructed']} (H ratio max {ps['h_vs_serial_max_ratio']:.4f})")
EOF
rm -rf "$out"

echo "== observability arm (trace/metrics on the mini grid) =="
# recording on vs off: byte-identical artifacts under the deterministic
# clock; the trace and metrics valid against the reference's schemas (read
# only); tracing + flight recording under 5 % of an untraced run, measured
# as verify.sh measures it (in-process paired reps for the cost, cold child
# runs for the denominator, CPU time via getrusage)
oout="$(mktemp -d)"
python -m repro_torch.experiments.run --grid mini --device "$device" -q --cache-dir "$oout/cache" \
    --md "$oout/warm.md" --json "$oout/warm.json"   # warm the sweep cache
REPRO_OBS_DETERMINISTIC=1 python -m repro_torch.experiments.run --grid mini --device "$device" -q \
    --cache-dir "$oout/cache" --md "$oout/off.md" --json "$oout/off.json"
REPRO_OBS_DETERMINISTIC=1 python -m repro_torch.experiments.run --grid mini --device "$device" -q \
    --cache-dir "$oout/cache" --md "$oout/on.md" --json "$oout/on.json" \
    --trace-out "$oout/trace.json" --metrics-out "$oout/metrics.json"
cmp "$oout/off.md" "$oout/on.md"
cmp "$oout/off.json" "$oout/on.json"
echo "recording on vs off: rendered artifacts byte-identical"
python -m repro_torch.obs.validate "$oout/trace.json" --schema schemas/trace.schema.json
python -m repro_torch.obs.validate "$oout/metrics.json" --schema schemas/metrics.schema.json
python - "$oout/trace.json" "$oout/metrics.json" <<'EOF'
import json, os, sys
trace = json.load(open(sys.argv[1]))
spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
assert "pipeline.sweep" in spans and "sweep.placement" in spans, sorted(spans)
counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
assert counters, "no per-link counter tracks in the trace"
assert trace["otherData"]["dropped_spans"] == 0, trace["otherData"]
heat = json.load(open(os.path.splitext(sys.argv[1])[0] + ".heatmap.json"))
assert heat["tracks"], "heatmap artifact has no tracks"
snap = json.load(open(sys.argv[2]))
stages = snap["non_comparable"]["sweep.stage_seconds"]["series"]
assert any(s["labels"]["stage"] == "placement" for s in stages), stages
tracks = {(e["pid"], e["name"]) for e in counters}
print(f"obs arm ok: {len(spans)} span names, {len(tracks)} counter tracks,"
      f" {len(heat['tracks'])} heatmap tracks")
EOF
python - "$oout" "$device" <<'EOF'
import os, resource, statistics, subprocess, sys
out, device = sys.argv[1], sys.argv[2]
argv = ["--grid", "mini", "--device", device, "-q", "--cache-dir", os.path.join(out, "cache"),
        "--md", os.path.join(out, "t.md"), "--json", os.path.join(out, "t.json")]
traced_extra = ["--trace-out", os.path.join(out, "t.trace.json"),
                "--metrics-out", os.path.join(out, "t.metrics.json")]
cold_cmd = [sys.executable, "-m", "repro_torch.experiments.run"] + argv
def cold():
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    subprocess.run(cold_cmd, check=True, capture_output=True)
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
cold()  # warm the sweep cache
denom = statistics.median(cold() for _ in range(3))
from repro_torch import obs
from repro_torch.experiments.run import main
def rep(extra):
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    main(argv + extra)
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    obs.disable_tracing()
    obs.get_tracer().reset()
    return (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
rep([]); rep(traced_extra)  # warm both paths
diffs = []
for i in range(7):
    if i % 2 == 0:
        p = rep([]); t = rep(traced_extra)
    else:
        t = rep(traced_extra); p = rep([])
    diffs.append(t - p)
num = statistics.median(diffs)
overhead = num / denom * 100.0
assert overhead < 5.0, (
    f"tracing overhead {overhead:.1f}% >= 5%"
    f" ({num*1e3:.1f}ms added to a {denom*1e3:.0f}ms untraced run)"
)
print(f"obs overhead ok: +{overhead:.1f}% ({num*1e3:.1f}ms obs cost,"
      f" median of 7 paired reps, vs {denom*1e3:.0f}ms untraced run)")
EOF
rm -rf "$oout"

echo "== resilience arm (mini faults grid + crash-resume smoke) =="
rout="$(mktemp -d)"
python -m repro_torch.experiments.run --grid minifaults --backend auto --device "$device" -q \
    --cache-dir "$rout/cache" --sweeps-dir "$rout/a" --journal "$rout/a.journal.json"
python - "$rout/a/minifaults.json" <<'EOF'
import json, sys
payload = json.load(open(sys.argv[1]))["faults"]
recs = payload["records"]
assert recs, "minifaults produced no unit records"
rates = {r["fault_rate"] for r in recs}
assert rates == {0.0, 0.05}, f"unexpected fault rates {rates}"
clean = next(r for r in recs if r["fault_rate"] == 0.0)
faulted = next(r for r in recs if r["fault_rate"] == 0.05)
assert clean["win"] > 1.0, f"proposed scheme does not win on the clean fabric: {clean['win']}"
assert faulted["num_dead_links"] > 0 and faulted["num_detoured_flows"] > 0, faulted
assert payload["repair"], "no repair-ledger rows"
for row in payload["repair"]:
    assert row["batch_parity"], f"repair serial/batched mismatch: {row}"
    assert row["h_repaired"] <= row["h_evacuated"] + 1e-9, row
assert not payload["quarantined"], f"quarantined units: {payload['quarantined']}"
parity = payload["backend_parity_max_rel"]
assert parity is not None, "the torch arm did not run beside numpy"
assert parity <= payload["parity_rtol"], f"degraded-arm parity {parity:.3e}"
print(f"resilience ok: win {clean['win']:.2f}x -> {faulted['win']:.2f}x at 5% faults;"
      f" torch parity {parity:.2e} <= {payload['parity_rtol']:g}")
EOF
# kill -9 between journal flushes, resume, compare bytes
REPRO_FAULTS_UNIT_DELAY=2.0 python -m repro_torch.experiments.run --grid minifaults \
    --backend auto --device "$device" -q --cache-dir "$rout/cache" --sweeps-dir "$rout/b" \
    --journal "$rout/b.journal.json" &
victim=$!
for _ in $(seq 1 300); do
    python - "$rout/b.journal.json" <<'EOF' && break
import json, sys
try:
    raise SystemExit(0 if json.load(open(sys.argv[1])).get("units") else 1)
except (FileNotFoundError, json.JSONDecodeError):
    raise SystemExit(1)
EOF
    sleep 0.1
done
kill -9 "$victim" 2>/dev/null || true
wait "$victim" 2>/dev/null || true
python -m repro_torch.experiments.run --grid minifaults --backend auto --device "$device" -q --resume \
    --cache-dir "$rout/cache" --sweeps-dir "$rout/b" --journal "$rout/b.journal.json"
cmp "$rout/a/minifaults.json" "$rout/b/minifaults.json"
echo "crash-resume smoke ok: resumed artifact is byte-identical"
rm -rf "$rout"

echo "== backpressure arm (minicredit grid: credit flow control end to end) =="
bout="$(mktemp -d)"
python -m repro_torch.experiments.run --grid minicredit --backend auto --device "$device" -q \
    --cache-dir "$bout/cache" --sweeps-dir "$bout/sweeps" --json "$bout/minicredit.json"
python - "$bout/minicredit.json" <<'EOF'
import json, sys
payload = json.load(open(sys.argv[1]))["contention"]
recs = payload["records"]
assert recs, "minicredit produced no contended records"
depths = {r["buffer_depth"] for r in recs if r["flow_control"] == "credit"}
assert depths == {1.0, 4.0}, f"unexpected credit depth axis {depths}"
n_open = sum(r["flow_control"] == "open" for r in recs)
n_credit = sum(r["flow_control"] == "credit" for r in recs)
assert n_open > 0 and n_credit == 2 * n_open, (n_open, n_credit)
inf_np = payload["credit_inf_numpy_max_abs"]
assert inf_np == 0.0, f"infinite-credit numpy audit not bit-exact: {inf_np}"
rtol = payload["parity_rtol"]
parity = payload["backend_parity_max_rel"]
inf_torch = payload["credit_inf_torch_max_rel"]
assert parity is not None and parity <= rtol, f"credit-arm parity {parity} > {rtol:g}"
assert inf_torch is not None and inf_torch <= rtol, f"inf-credit torch {inf_torch}"
print(f"backpressure ok: {n_credit} credit records over depths {sorted(depths)};"
      f" inf-credit numpy exact, torch {inf_torch:.2e}; parity {parity:.2e}")
EOF
rm -rf "$bout"

echo "== dry-run records (every cell on 'meta') =="
python -m repro_torch.launch.dryrun --all --out artifacts/torch/dryrun

echo "VERIFY TORCH OK"
