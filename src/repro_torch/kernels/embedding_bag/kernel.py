"""Build, argument checks and launch of the CUDA kernel `csrc/embedding_bag.cu`.

Importing this module builds nothing and needs no CUDA: `nvcc` runs at the
first launch (see `repro_torch.kernels.build`).  `embedding_bag_cuda` takes
CUDA tensors only and raises on anything the kernel does not take — int32
ids, float32 weights, contiguous tensors — rather than casting; the choice
between kernel and plain version is made in `ops.py`.  Each launch adds one
to `ops.embedding_bag.launches`, here and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.embedding_bag import ops

__all__ = ["LIBRARY", "embedding_bag_cuda"]

LIBRARY = "embedding_bag"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = load_library(LIBRARY).embedding_bag_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tables ids weights out
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bags T V D L
            ctypes.c_int, ctypes.c_void_p,  # dtype code, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype, ndim: int):
    if t.device != device:
        raise ValueError(f"embedding_bag: {name} lies on {t.device}, tables on {device}")
    if t.dtype != dtype:
        raise TypeError(f"embedding_bag: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"embedding_bag: {name} must have {ndim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"embedding_bag: {name} must be contiguous")


def embedding_bag_cuda(
    tables: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """tables (T, V, D) f32|bf16; ids (B, T, L) int32 (outside [0, V) ⇒ pad);
    weights (B, T, L) f32 or None → (B, T, D) in the tables' type.  One launch
    on the current stream, no synchronisation; the output is the only
    allocation (no ones tensor stands in for absent weights)."""
    if not tables.is_cuda:
        raise ValueError("embedding_bag_cuda takes CUDA tensors; the plain version is ref.embedding_bag_ref")
    if tables.dtype not in _DTYPE_CODE:
        raise TypeError(f"embedding_bag: tables must be float32 or bfloat16, got {tables.dtype}")
    _check("tables", tables, tables.device, tables.dtype, 3)
    _check("ids", ids, tables.device, torch.int32, 3)
    if weights is not None:
        _check("weights", weights, tables.device, torch.float32, 3)
        if weights.shape != ids.shape:
            raise ValueError(f"embedding_bag: weights {tuple(weights.shape)} != ids {tuple(ids.shape)}")
    t, v, d = tables.shape
    b, t2, l = ids.shape
    if t2 != t:
        raise ValueError(f"embedding_bag: {t} tables, ids for {t2}")
    if v == 0 or d == 0:
        raise ValueError(f"embedding_bag: empty tables {tuple(tables.shape)}")
    out = torch.empty((b, t, d), dtype=tables.dtype, device=tables.device)
    if out.numel() == 0:
        return out
    args = (
        tables.data_ptr(), ids.data_ptr(), weights.data_ptr() if weights is not None else None,
        out.data_ptr(), b * t, t, v, d, l, _DTYPE_CODE[tables.dtype],
    )
    if tables.device.index == torch.cuda.current_device():
        err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the launch goes to the device that holds the tensors
        with torch.cuda.device(tables.device):
            err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag: launch failed with CUDA error {err} (-1: refused arguments)")
    ops.embedding_bag.launches += 1
    return out
