"""Dispatching wrappers: the CUDA kernels for a CUDA tensor, the plain
versions for a CPU tensor.

`flash_attention` is the one entry point the models call.  Selection:
  impl="auto"  → "cuda" for a CUDA `q`, "ref" for a CPU `q` — but with grad
                 on and an input that requires it, the autograd Function
                 `_FlashAttention` on either device: its forward is the kernel
                 (with each row's log-sum-exp) or the plain version, its
                 backward `flash_attention_bwd`
  impl="cuda"  → the hand-written kernel `csrc/flash_attention.cu` (through
                 the Function when a gradient is wanted); raises on a CPU
                 tensor and on `kv_valid_len`, as the TPU kernel does
  impl="ref"   → the blocked plain version `ref.flash_attention_ref`, which
                 autograd differentiates (the tests' oracle)
  impl="naive" → the unblocked plain version (small shapes only)
`flash_attention_bwd` is the backward: the kernels of `csrc/flash_attention_bwd.cu`
for a CUDA tensor (bf16: `wgmma` on the tensor cores; float32: fp32 products
on the CUDA cores; the TPU kernel had none, the reference differentiates its
attention by autodiff), `ref.flash_attention_bwd_ref` for a CPU tensor.
Nothing here catches a failure and falls back.  `flash_attention.launches`
and `flash_attention_bwd.launches` count kernel launches (plain integers);
`kernel.py` adds one where it launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    naive_attention_ref,
)

__all__ = ["flash_attention", "flash_attention_bwd", "IMPLS"]

IMPLS = ("auto", "cuda", "ref", "naive")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid_len: torch.Tensor | None = None,
    impl: str = "auto",
    block_q: int = 512,
    block_k: int = 512,
    skip_masked_blocks: bool = False,
) -> torch.Tensor:
    """q (B, Sq, Hq, dh), k/v (B, Skv, Hkv, dh) → (B, Sq, Hq, dh) in q's type.
    `block_q`/`block_k`/`skip_masked_blocks` shape the plain version only; the
    kernel has its own tiles and always skips kv tiles above the diagonal."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {'|'.join(IMPLS)}")
    if impl == "naive":
        return naive_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
    wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if impl == "ref" or (impl == "auto" and not q.is_cuda and not wants_grad):
        return flash_attention_ref(
            q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
            block_q=block_q, block_k=block_k, skip_masked_blocks=skip_masked_blocks,
        )
    if kv_valid_len is not None:
        raise NotImplementedError(
            "kv_valid_len: the flash-attention kernel and its backward cover prefill, forward and "
            "training; use impl='ref' for decode masking"
        )
    if impl == "cuda" and not q.is_cuda:
        raise ValueError("flash_attention(impl='cuda') takes CUDA tensors; the plain version is impl='ref'")
    if wants_grad:
        return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset), (block_q, block_k, skip_masked_blocks))
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Attention whose backward is `flash_attention_bwd`.  Forward: the kernel
    with its log-sum-exp for a CUDA `q`, the plain version (with the
    caller's blocks) for a CPU `q`; saves q, k, v, the output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, blocks):
        if q.is_cuda:
            from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

            out, lse = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset, with_lse=True)
        else:
            block_q, block_k, skip = blocks
            out, lse = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, block_q=block_q,
                                           block_k=block_k, skip_masked_blocks=skip, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=ctx.causal, q_offset=ctx.q_offset)
        need = ctx.needs_input_grad
        return dq if need[0] else None, dk if need[1] else None, dv if need[2] else None, None, None, None


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention(q, k, v)` for the output cotangent
    `dout`, from the forward's output `o` and log-sum-exp `lse` (B, Hq, Sq):
    the backward kernel for a CUDA `q` (its inputs made contiguous and of q's
    type first), `ref.flash_attention_bwd_ref` for a CPU `q`."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, dout, lse, causal=causal, q_offset=q_offset)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda

    q, k, v, o, dout = (t.to(q.dtype).contiguous() for t in (q, k, v, o, dout))
    return flash_attention_bwd_cuda(q, k, v, o, dout, lse.contiguous(), causal=causal, q_offset=q_offset)


flash_attention_bwd.launches = 0
