#!/usr/bin/env python3
"""Times the build-up steps of the bf16 flash-attention kernel on one GPU.

    python3 tools/attention_steps.py [--stages 1 2 3] [--out chiprun_out/attention_steps.jsonl]

`csrc/flash_attention.cu` takes the depth of its K/V ring from the macro
`FA_STAGES` (3 when it is not set, the build the port uses).  This script
compiles the source once for each depth, all at once, into `build/`, and runs
each build in turn through the port's own wrapper at the serve path's
shapes (llama3.2-3b prefill: q (1, S, 24, 128), k/v (1, S, 8, 128) bf16,
causal, S = 512, 2048, 3072): the result against the plain version (bf16
tolerance) and a second run (bit-equal), then the device time of a CUDA-graph
replay, achieved TFLOP/s and the operation bound, beside
`scaled_dot_product_attention`'s device time on the same inputs.  A depth of 1
is step (a) of the redesign (wgmma, one stage of loads: tile j+1 is copied
only once tile j is done); 2 and 3 are step (b), the TMA ring.  One JSON line
a build and shape, then one with the card's name and power limit.
Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PATH_S = (512, 2048, 3072)


def build_variant(stages: int) -> pathlib.Path:
    from repro_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, build_dir, find_nvcc

    source = CSRC_DIR / "flash_attention.cu"
    flags = (*NVCC_FLAGS, f"-DFA_STAGES={stages}")
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    lib = build_dir() / f"libflash_attention_stages{stages}_{digest}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([find_nvcc(), *flags, "-o", str(lib), str(source)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed at FA_STAGES={stages}:\n{done.stdout}\n{done.stderr}")
    return lib


def measure(libs: dict) -> list[dict]:
    """Each library (label → path of a build of `csrc/flash_attention.cu`)
    through the port's wrapper at the path's shapes: one dict a build and S."""
    import torch.nn.functional as F

    from chip_smoke import BF16_TOL, Timer, attention_bound_ms, attention_flops
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    timer = Timer()
    rng = np.random.default_rng(1)
    inputs = {}
    for s in PATH_S:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
                   for shape in ((1, s, 24, 128), (1, s, 8, 128), (1, s, 8, 128)))
        want = flash_attention_ref(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = timer.device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        inputs[s] = (q, k, v, want, lib_ms)
    lines = []
    for name, path in libs.items():
        kernel._FN = kernel.bind_launcher(ctypes.CDLL(str(path)))  # this build's launcher for the wrapper
        for s, (q, k, v, want, lib_ms) in inputs.items():
            got = kernel.flash_attention_cuda(q, k, v, causal=True)
            again = kernel.flash_attention_cuda(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.allclose(got.float(), want.float(), **BF16_TOL)) and bool(torch.equal(got, again))
            ms = timer.device_ms(lambda: kernel.flash_attention_cuda(q, k, v, causal=True))
            bound, by = attention_bound_ms(q, k, True, 0)
            line = {"build": name, "S": s, "ok": ok, "max_abs_err": err, "ms": ms,
                    "tflops": attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12, "bound_ms": bound,
                    "bound_by": by, "library_device_ms": lib_ms}
            print(json.dumps(line), flush=True)
            lines.append(line)
    kernel._FN = None  # the port's own build again
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_steps: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    from repro_torch.device import probe

    with ThreadPoolExecutor(len(args.stages)) as pool:  # one nvcc a build, all at once
        libs = dict(zip(args.stages, pool.map(build_variant, args.stages)))
    lines = measure(libs)
    for line in lines:
        line["step"] = "a" if line["build"] == 1 else "b"
    card = probe()["nvidia_smi"]
    print(json.dumps({"card": card}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines + [{"card": card}]))
    return 0 if all(x["ok"] for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
