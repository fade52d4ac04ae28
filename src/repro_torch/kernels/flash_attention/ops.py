"""Dispatching wrapper: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

`flash_attention` is the one entry point the models call.  Selection:
  impl="auto"  → "cuda" for a CUDA `q`, "ref" for a CPU `q`
  impl="cuda"  → the hand-written kernel `csrc/flash_attention.cu`; raises on
                 a CPU tensor and on `kv_valid_len`, as the TPU kernel does,
                 and, first of all, when grad is on and an input requires it:
                 the kernel has no backward (neither has the TPU kernel), and
                 its output would silently detach from the graph
  impl="ref"   → the blocked plain version `ref.flash_attention_ref`
  impl="naive" → the unblocked plain version (small shapes only)
Nothing here catches a failure and falls back.  `flash_attention.launches`
counts kernel launches (a plain integer); `kernel.py` adds one where it
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref, naive_attention_ref

__all__ = ["flash_attention", "IMPLS"]

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
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "naive":
        return naive_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
    if impl == "ref":
        return flash_attention_ref(
            q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
            block_q=block_q, block_k=block_k, skip_masked_blocks=skip_masked_blocks,
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no backward, and an input requires grad; "
            "use impl='ref' to differentiate (the kernel's backward is ROADMAP.md Queue B 4)"
        )
    if kv_valid_len is not None:
        raise NotImplementedError(
            "kv_valid_len: the flash-attention kernel covers prefill and forward; "
            "use impl='ref' for decode masking"
        )
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


flash_attention.launches = 0
