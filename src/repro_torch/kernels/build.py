"""Builds a CUDA source of `repro_torch/csrc/` into a shared library with
`nvcc` and loads it with `ctypes`.

The sources have a plain C interface and include no PyTorch header, so a build
takes seconds.  It happens at first use, never at import; the library goes
into `build/` at the repository root, named by a hash of the source so that an
edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["CSRC_DIR", "NVCC_FLAGS", "build_dir", "find_nvcc", "build_library", "load_library",
           "launch_on_device"]

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    # src/repro_torch/kernels/build.py → the repository root is three levels up
    return pathlib.Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch cannot be built")
    return exe


def build_library(name: str) -> pathlib.Path:
    """Compile `csrc/<name>.cu` (if its library is not there yet) and return
    the library's path.  Raises with the compiler's output on failure."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out_dir = build_dir()
    lib = out_dir / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{done.stdout}\n{done.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """`build_library` + `ctypes.CDLL`, once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build_library(name)))
    return lib


def launch_on_device(fn, device, args: tuple) -> int:
    """Call a library's launcher with `args` and the current stream of
    `device` (the CUDA device that holds the tensors); returns its code."""
    import torch

    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)
