"""Build, argument checks and launch of the CUDA kernels of `csrc/ell_spmm.cu`.

Importing this module builds nothing and needs no CUDA: `nvcc` runs at the
first launch (see `repro_torch.kernels.build`).  `ell_spmm_cuda` (one bucket)
and `segment_spmm_cuda` (the whole reduce in one launch) take CUDA tensors
only and raise on anything the kernels do not take; the choice between kernel
and plain version is made in `ops.py`.  Each launch adds one to
`ops.ell_spmm.launches` or `ops.segment_spmm.launches`, here and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.graph.structs import EllBlocks
from repro_torch.kernels.build import build_library, launch_on_device, load_library
from repro_torch.kernels.segment_spmm import ops

__all__ = ["LIBRARY", "build", "ell_spmm_cuda", "segment_spmm_cuda"]

LIBRARY = "ell_spmm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_FUSED = None


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


def _fused_launcher():
    global _FUSED
    if _FUSED is None:
        fn = load_library(LIBRARY).segment_spmm_launch
        fn.argtypes = [
            *([ctypes.c_void_p] * 7),  # x cols wts rows items zero_rows out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,  # n d n_items n_zero
            ctypes.c_int, ctypes.c_void_p,  # dtype code, stream
        ]
        fn.restype = ctypes.c_int
        _FUSED = fn
    return _FUSED


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
    err = launch_on_device(_launcher(), x.device, args)
    if err != 0:
        raise RuntimeError(f"ell_spmm: launch failed with CUDA error {err} (-1: refused arguments)")
    ops.ell_spmm.launches += 1
    return out


def segment_spmm_cuda(x: torch.Tensor, ell: EllBlocks) -> torch.Tensor:
    """x (N, D) f32|bf16, N = ell.num_nodes → (N, D) in x's type: every bucket
    of `ell` in one launch on the current stream, each row stored to its
    vertex, vertices in no bucket 0.  No synchronisation; the output is the
    only allocation."""
    if not x.is_cuda:
        raise ValueError("segment_spmm_cuda takes CUDA tensors; the plain version is ref.segment_spmm_ref")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_spmm: x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.device, x.dtype, 2)
    n, d = x.shape
    if n != ell.num_nodes:
        raise ValueError(f"segment_spmm: x has {n} rows, the graph {ell.num_nodes} vertices")
    if n == 0 or d == 0:
        raise ValueError(f"segment_spmm: empty x {tuple(x.shape)}")
    work = ell.work()
    _check("cols", work.cols, x.device, torch.int32, 1)
    _check("rows", work.rows, x.device, torch.int32, 1)
    _check("items", work.items, x.device, torch.int64, 2)
    _check("zero_rows", work.zero_rows, x.device, torch.int32, 1)
    if work.weights is not None:
        _check("weights", work.weights, x.device, torch.float32, 1)
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    args = (
        x.data_ptr(), work.cols.data_ptr(), work.weights.data_ptr() if work.weights is not None else None,
        work.rows.data_ptr(), work.items.data_ptr(), work.zero_rows.data_ptr(), out.data_ptr(),
        n, d, work.items.shape[0], work.zero_rows.numel(), _DTYPE_CODE[x.dtype],
    )
    err = launch_on_device(_fused_launcher(), x.device, args)
    if err != 0:
        raise RuntimeError(f"segment_spmm: launch failed with CUDA error {err} (-1: refused arguments)")
    ops.segment_spmm.launches += 1
    return out
