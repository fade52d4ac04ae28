"""Build, argument checks and launch of the CUDA kernels `csrc/flash_attention.cu`
(forward) and `csrc/flash_attention_bwd.cu` (backward).

Importing this module builds nothing and needs no CUDA: `nvcc` runs at the
first launch (see `repro_torch.kernels.build`).  `flash_attention_cuda` and
`flash_attention_bwd_cuda` take CUDA tensors only and raise on anything the
kernels do not take; the choice between kernel and plain version is made in
`ops.py`.  Each launch adds one to `ops.flash_attention.launches` or
`ops.flash_attention_bwd.launches`, here and nowhere else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import launch_on_device, load_library
from repro_torch.kernels.flash_attention import ops

__all__ = ["LIBRARY", "LIBRARY_BWD", "HEAD_DIMS", "BWD_ROUTES", "BWD_KERNEL_NAMES", "bind_launcher",
           "flash_attention_cuda", "flash_attention_bwd_cuda", "kernel_info", "bwd_kernel_info",
           "bwd_kernel_launches", "bwd_consumer_groups"]

LIBRARY = "flash_attention"
LIBRARY_BWD = "flash_attention_bwd"
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_BWD = None
_ERRORS = "-1: refused arguments, -2: the driver refused a tensor map of q, k or v"
_BWD_ERRORS = "-1: refused arguments, -2: the driver refused a tensor map of q, k, v or dout"
# the backward's kernels by input type, launched in this order on one stream
BWD_ROUTES = {
    torch.bfloat16: "attn_bwd_delta + attn_bwd_dkdv_wgmma + attn_bwd_dq_wgmma (wgmma m64nNk16 fed by a TMA ring)",
    torch.float32: "attn_bwd_delta + attn_bwd_dkdv + attn_bwd_dq (fp32 FMA on the CUDA cores)",
}
BWD_KERNELS = {"dkdv": 0, "dq": 1}  # the bf16 kernels, as flash_attention_bwd_kernel_info numbers them
_ROW_PAD = 64  # the backward's scratch pads each (b, h) row block to a multiple of this


def bind_launcher(lib: ctypes.CDLL):
    """The library's `flash_attention_launch` with its argument types set."""
    fn = lib.flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v out lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B Sq Skv Hq Hkv dh
        *([ctypes.c_longlong] * 9),  # (b, s, h) strides of q, k, v
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,  # causal q_offset scale dtype
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _launcher():
    global _FN
    if _FN is None:
        _FN = bind_launcher(load_library(LIBRARY))
    return _FN


def _bwd_launcher():
    global _BWD
    if _BWD is None:
        fn = load_library(LIBRARY_BWD).flash_attention_bwd_launch
        fn.argtypes = [
            *([ctypes.c_void_p] * 10),  # q k v o dout lse scratch dq dk dv
            *([ctypes.c_int] * 8),  # B Sq Skv Hq Hkv dh causal q_offset
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # scale dtype stream
        ]
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def _check(name: str, t: torch.Tensor, like: torch.Tensor):
    if t.device != like.device:
        raise ValueError(f"flash_attention: {name} lies on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {like.dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be (B, S, H, dh), got {tuple(t.shape)}")
    # 16-byte vector loads along dh: unit stride there, aligned rows
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs unit stride along dh and 16-byte aligned rows, "
            f"got strides {t.stride()}"
        )


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    b, sq, hq, dh = q.shape
    bk_, skv, hkv, dk = k.shape
    if v.shape != k.shape or bk_ != b or dk != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a multiple of {hkv} kv heads")


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0,
    with_lse: bool = False,
):
    """q (B, Sq, Hq, dh), k/v (B, Skv, Hkv, dh), f32|bf16, dh ∈ {32, 64, 128},
    Hq a multiple of Hkv → (B, Sq, Hq, dh) in q's type, and with `with_lse`
    also each row's log-sum-exp of the scaled scores, float32 (B, Hq, Sq).
    One launch on the current stream, no synchronisation; the outputs are the
    only allocations."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors; the plain version is ref.flash_attention_ref")
    _check_shapes(q, k, v)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
        b, sq, skv, hq, hkv, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), int(q_offset), 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
    )
    err = launch_on_device(_launcher(), q.device, args)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error {err} ({_ERRORS})")
    ops.flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, *, causal: bool = True, q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention_cuda(q, k, v)` for the
    output cotangent `dout`, from the forward's output `o` and `lse` (float32
    (B, Hq, Sq)); q, k, v, o, dout of one type and contiguous (the autograd
    Function makes them so).  One call of the backward library, three
    launches on the current stream (`BWD_ROUTES[q.dtype]`: for bf16 the
    `wgmma` kernels, for float32 the FMA kernels), no synchronisation; the
    gradients and a float32 scratch (2, B, Hq, Sq rounded up to 64) for each
    row's D and lse are the only allocations.  A refused or failed launch
    raises."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda takes CUDA tensors; the plain version is "
                         "ref.flash_attention_bwd_ref")
    _check_shapes(q, k, v)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t, like in (("o", o, q), ("dout", dout, q)):
        _check(name, t, like)
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} != q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("dout", dout)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous")
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 {(b, hq, sq)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if skv == 0:
        raise ValueError("flash_attention_bwd: no keys (Skv = 0)")
    scratch = torch.empty((2, b, hq, -(-sq // _ROW_PAD) * _ROW_PAD), dtype=torch.float32, device=q.device)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, skv, hq, hkv, dh, int(bool(causal)), int(q_offset), 1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
    )
    err = launch_on_device(_bwd_launcher(), q.device, args)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: launch failed with CUDA error {err} ({_BWD_ERRORS})")
    ops.flash_attention_bwd.launches += 1
    return dq, dk, dv


def kernel_info(dh: int, consumer_groups: int) -> dict:
    """Resources of the bf16 kernel at head dim `dh` with 1 or 2 consumer
    warpgroups (64- or 128-row q tiles), from `cudaFuncGetAttributes`:
    registers a thread at launch (the consumers raise theirs with
    `setmaxnreg`), spilled bytes a thread, dynamic shared memory and threads a
    block.  Builds the library if it is not built yet."""
    fn = load_library(LIBRARY).flash_attention_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, *([ctypes.POINTER(ctypes.c_int)] * 4)]
    fn.restype = ctypes.c_int
    return _resources(_int_out(fn, dh, consumer_groups, n=4))


def _int_out(fn, *args, n: int) -> list[int]:
    """Call `fn(*args, &o1, .., &on)` on n C ints; raises unless it returns 0."""
    out = [ctypes.c_int(0) for _ in range(n)]
    err = fn(*args, *[ctypes.byref(v) for v in out])
    if err != 0:
        raise RuntimeError(f"{fn.__name__}{args} failed with {err}")
    return [v.value for v in out]


def _resources(values: list[int]) -> dict:
    regs, local, smem, threads = values
    return {"registers_at_launch": regs, "local_bytes": local, "dynamic_smem_bytes": smem, "threads": threads}


def bwd_kernel_info(dh: int, consumer_groups: int, kernel: str) -> dict:
    """Resources of the backward's bf16 kernel `kernel` ("dkdv", two consumer
    warpgroups; or "dq", 1 or 2) at head dim `dh`, from
    `cudaFuncGetAttributes`, as `kernel_info` gives the forward's.  Builds the
    library if it is not built yet."""
    fn = load_library(LIBRARY_BWD).flash_attention_bwd_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, *([ctypes.POINTER(ctypes.c_int)] * 4)]
    fn.restype = ctypes.c_int
    return _resources(_int_out(fn, dh, consumer_groups, BWD_KERNELS[kernel], n=4))


BWD_KERNEL_NAMES = ("attn_bwd_delta", "attn_bwd_dkdv_wgmma", "attn_bwd_dq_wgmma", "attn_bwd_dkdv", "attn_bwd_dq")


def bwd_kernel_launches() -> dict:
    """Launches of each backward kernel (`BWD_KERNEL_NAMES`; the last two are
    the float32 route's) since the library was loaded, counted by the library
    where it launches them: which route the calls took, without a profiler."""
    fn = load_library(LIBRARY_BWD).flash_attention_bwd_kernel_launches
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * len(BWD_KERNEL_NAMES))()
    fn(out)
    return dict(zip(BWD_KERNEL_NAMES, out))


def bwd_consumer_groups(b: int, sq: int, skv: int, hq: int, hkv: int) -> dict:
    """Consumer warpgroups a block that a bf16 backward of this shape gives
    its dK/dV kernel (always 2, split by role) and its dQ kernel (2 when that
    still puts a block on every SM, else 1)."""
    fn = load_library(LIBRARY_BWD).flash_attention_bwd_groups
    fn.argtypes = [*([ctypes.c_int] * 5), *([ctypes.POINTER(ctypes.c_int)] * 2)]
    fn.restype = ctypes.c_int
    dkdv, dq = _int_out(fn, b, sq, skv, hq, hkv, n=2)
    return {"dkdv": dkdv, "dq": dq}
