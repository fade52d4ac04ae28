"""Build, argument checks and launch of the CUDA kernel `csrc/ell_spmm.cu`.

Importing this module builds nothing and needs no CUDA: `nvcc` runs at the
first launch (see `repro_torch.kernels.build`).  `ell_spmm_cuda` takes CUDA
tensors only and raises on anything the kernel does not take; the choice
between kernel and plain version is made in `ops.py`.  Each launch adds one to
`ops.ell_spmm.launches`, here and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import build_library, load_library
from repro_torch.kernels.segment_spmm import ops

__all__ = ["LIBRARY", "build", "ell_spmm_cuda"]

LIBRARY = "ell_spmm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def build():
    """Compile the kernel's library now (idempotent); returns its path."""
    return build_library(LIBRARY)


def _launcher():
    global _FN
    if _FN is None:
        fn = load_library(LIBRARY).ell_spmm_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x cols wts out
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,  # n d r w
            ctypes.c_int, ctypes.c_void_p,  # dtype code, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype, ndim: int):
    if t.device != device:
        raise ValueError(f"ell_spmm: {name} lies on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"ell_spmm: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"ell_spmm: {name} must have {ndim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"ell_spmm: {name} must be contiguous")


def ell_spmm_cuda(
    x: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor | None = None
) -> torch.Tensor:
    """x (N, D) f32|bf16; cols (R, W) int32 (outside [0, N) ⇒ pad); wts (R, W)
    f32 or None → (R, D) in x's type.  One launch on the current stream, no
    synchronisation; the output is the only allocation."""
    if not x.is_cuda:
        raise ValueError("ell_spmm_cuda takes CUDA tensors; the plain version is ref.ell_spmm_ref")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ell_spmm: x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.device, x.dtype, 2)
    _check("cols", cols, x.device, torch.int32, 2)
    if wts is not None:
        _check("wts", wts, x.device, torch.float32, 2)
        if wts.shape != cols.shape:
            raise ValueError(f"ell_spmm: wts {tuple(wts.shape)} != cols {tuple(cols.shape)}")
    n, d = x.shape
    r, w = cols.shape
    if n == 0 or d == 0 or w == 0:
        raise ValueError(f"ell_spmm: empty dimension in x {tuple(x.shape)} / cols {tuple(cols.shape)}")
    out = torch.empty((r, d), dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    args = (
        x.data_ptr(), cols.data_ptr(), wts.data_ptr() if wts is not None else None,
        out.data_ptr(), n, d, r, w, _DTYPE_CODE[x.dtype],
    )
    if x.device.index == torch.cuda.current_device():
        err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the launch goes to the device that holds the tensors
        with torch.cuda.device(x.device):
            err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmm: launch failed with CUDA error {err} (-1: refused arguments)")
    ops.ell_spmm.launches += 1
    return out
