#!/usr/bin/env python3
"""The attention backward's bf16 kernels on one GPU: what `ptxas` made of them,
then each held against its plain version and timed.

    python3 tools/attention_bwd.py [--out chiprun_out/attention_bwd.jsonl] [--compare other.cu]

First it compiles `csrc/flash_attention_bwd.cu` with the port's flags plus
`-Xptxas -v` and prints, for each `wgmma` kernel, the registers, spilled
bytes and any warning `ptxas` gave (a serialised `wgmma` shows there).  Then
it runs `ops.flash_attention_bwd` through the port's wrapper at
llama3.2-3b's training shape (q (8, 128, 24, 128), k/v (8, 128, 8, 128)) and
at the serve path's S = 2048 (q (1, 2048, 24, 128), k/v (1, 2048, 8, 128)),
bf16, causal, on the forward kernel's output and lse: the gradients against
`flash_attention_bwd_ref` (1e-2 of each one's largest magnitude), a second
run bit-equal, then the device time of a CUDA-graph replay beside the
operation and byte bound (as `chip_smoke.py` counts them), each kernel's
device time (`torch.profiler`), the plain version and the backward of
`scaled_dot_product_attention`.  With `--compare`, another version of the
source is built with the same flags and both are timed in turns (this,
other, other, this) through the same wrapper.  One JSON line a shape, then
one with the card's name and power limit.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPES = {"train": (8, 128, 24, 8, 128), "serve": (1, 2048, 24, 8, 128)}  # (B, S, Hq, Hkv, dh)
REL = 1e-2


def ptxas_report() -> dict:
    """Registers, spill stores and warnings of each `wgmma` kernel, from `nvcc
    -Xptxas -v` on the port's own flags."""
    from repro_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, find_nvcc

    with tempfile.TemporaryDirectory() as tmp:
        done = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/lib.so",
                               str(CSRC_DIR / "flash_attention_bwd.cu")], capture_output=True, text=True)
    text = done.stdout + done.stderr
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{text}")
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True, text=True).stdout.strip()
            current = name if "wgmma" in name else None
            if current:
                out[current] = {"warnings": []}
            continue
        if current is None:
            continue
        if "warning" in line:
            out[current]["warnings"].append(line.split("warning", 1)[1].strip(" :"))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_store_bytes"], out[current]["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
    return out


def device_ms(fn, calls: int = 5, reps: int = 10) -> float:
    """Median device time of one call, replayed from a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return events_ms(graph.replay, calls, reps)


def events_ms(run, calls: int, reps: int) -> float:
    run()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def call_ms(fn, calls: int = 5, reps: int = 10) -> float:
    """Median time of one call, `calls` enqueued back to back."""
    def run():
        for _ in range(calls):
            fn()
    return events_ms(run, calls, reps)


def kernels_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of each backward kernel, from `torch.profiler` over
    `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "attn_bwd" in e.key:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            name = e.key.replace("void (anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + float(us) / 1e3 / reps
    return out


def other_launcher(source: str):
    """`flash_attention_bwd_launch` of another version of the source, built
    with the port's flags, with the argument types `kernel.py` gives it."""
    import ctypes
    import hashlib

    from repro_torch.kernels.build import NVCC_FLAGS, build_dir, find_nvcc

    path = pathlib.Path(source)
    digest = hashlib.sha256(path.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = build_dir() / f"libflash_attention_bwd_other_{digest}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(path)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{done.stdout}\n{done.stderr}")
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
    fn.argtypes = [*([ctypes.c_void_p] * 10), *([ctypes.c_int] * 8), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def measure(name: str, shape, other=None) -> dict:
    import torch.nn.functional as F

    from chip_smoke import attention_bwd_bound_ms, attention_flops
    from repro_torch.kernels.flash_attention.kernel import bwd_consumer_groups, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, s, hq, hkv, dh = shape
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(x).astype(np.float32)).cuda().bfloat16()
                   for x in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh), (b, s, hq, dh)))
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    rel = [float((x.float() - y.float()).abs().max() / (y.float().abs().max() + 1e-6)) for x, y in zip(got, want)]
    bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
    del want
    bound, by = attention_bwd_bound_ms(q, k, True, 0)
    ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True))
    split = kernels_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True))
    compared = None
    if other is not None:
        from repro_torch.kernels.flash_attention import kernel

        this = kernel._bwd_launcher()
        turns = []
        for fn in (this, other, other, this):
            kernel._BWD = fn
            turns.append(device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True)))
        kernel._BWD = other
        theirs = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        kernel._BWD = this
        torch.cuda.synchronize()
        compared = {"this_ms": [turns[0], turns[3]], "other_ms": [turns[1], turns[2]],
                    "other_bit_equal": all(torch.equal(x, y) for x, y in zip(got, theirs))}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    return {
        "shape": name, "q": [b, s, hq, dh], "k": [b, s, hkv, dh], "consumer_groups": bwd_consumer_groups(b, s, s, hq, hkv),
        "max_rel_err_vs_plain": max(rel), "bit_equal_two_runs": bit_equal, "ms": ms, "kernels_ms": split,
        "compared": compared,
        "tflops": 2.5 * attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12, "bound_ms": bound, "bound_by": by,
        "plain_ms": call_ms(lambda: flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True), calls=2, reps=3),
        "library_ms": call_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    ap.add_argument("--compare", default=None, help="another version of csrc/flash_attention_bwd.cu to time in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_bwd: no CUDA device", file=sys.stderr)
        return 2
    lines = [{"ptxas": ptxas_report()}]
    print(json.dumps(lines[-1]), flush=True)
    ok = True
    other = other_launcher(args.compare) if args.compare else None
    for name, shape in SHAPES.items():
        lines.append(measure(name, shape, other))
        print(json.dumps(lines[-1]), flush=True)
        ok &= lines[-1]["max_rel_err_vs_plain"] <= REL and lines[-1]["bit_equal_two_runs"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lines.append({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ok": ok})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
