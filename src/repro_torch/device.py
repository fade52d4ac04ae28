"""Device and backend resolution shared by every entry point of the port.

Rule: `device=None` means the CUDA device and raises when there is none — an
entry point never drops to the CPU on its own.  Tests pass `device="cpu"`.
`backend="auto"` is `"torch"` whatever the problem size; numpy runs only when
asked for by name.
"""
from __future__ import annotations

import re
import shutil
import subprocess

import torch

__all__ = ["resolve_device", "resolve_backend", "probe", "smi_name_and_power_limit"]

BACKENDS = ("auto", "torch", "numpy")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` → `cuda` (raises without a CUDA device); anything else is taken
    as given, and a CUDA device that is asked for must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the host"
        )
    return dev


def resolve_backend(backend: str = "auto") -> str:
    """Map "auto" to "torch"; accept "torch" and "numpy" as they are."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {'|'.join(BACKENDS)}")
    return "torch" if backend == "auto" else backend


def smi_name_and_power_limit() -> str | None:
    """The line `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints for the first card, or None where there is no `nvidia-smi`."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _nvcc_release() -> str | None:
    exe = shutil.which("nvcc")
    if exe is None:
        return None
    out = subprocess.run([exe, "--version"], capture_output=True, text=True, check=False)
    m = re.search(r"release\s+([\d.]+)", out.stdout)
    return m.group(1) if m else None


def probe() -> dict:
    """What the port can see of its toolchain and card (plain dict, JSON-able)."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "capability": list(torch.cuda.get_device_capability(0)) if cuda else None,
        "nvcc_on_path": shutil.which("nvcc") is not None,
        "nvcc_release": _nvcc_release(),
        "nvidia_smi": smi_name_and_power_limit(),
    }
