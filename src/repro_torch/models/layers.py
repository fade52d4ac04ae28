"""Shared neural-network building blocks (PyTorch, plain-dict params).

The port of `repro.models.layers`, with the same dtype steps: fp32
statistics in `rms_norm`, fp32 rope tables with the result cast back to the
input's type, `gqa_attention` in fp32 with −1e30 masking and `kv_valid_len`.
Parameters are plain tensors in dicts (layer-stacked by the models), so that
the layout matches the JAX package's pytrees one for one.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = [
    "Initializer",
    "rms_norm",
    "rope_table",
    "apply_rope",
    "gqa_attention",
    "swiglu",
    "dense",
    "softmax_cross_entropy",
]


@dataclasses.dataclass
class Initializer:
    """Parameter draws from one explicit, seeded `torch.Generator`, made on
    the device the tensors go to (draws on the card stay on the card)."""

    generator: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device: torch.device) -> "Initializer":
        return cls(torch.Generator(device=device).manual_seed(int(seed)))

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def normal(self, shape, scale: float, dtype=torch.float32) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.generator, device=self.device, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def fan_in(self, shape, dtype=torch.float32) -> torch.Tensor:
        # variance-scaling on the contracted dim (second-to-last for matmuls)
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        return self.normal(shape, 1.0 / math.sqrt(fan), dtype)

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype, device=self.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation regardless of input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope_table(seq_len: int, d_head: int, *, theta: float = 10000.0,
               device: torch.device | str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (seq_len, d_head//2), fp32."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); cos/sin: (S, d_head//2) or broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over the head axis: (..., S, 1, half)
    s = sin[..., None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid_len: torch.Tensor | None = None,
    logits_soft_cap: float | None = None,
) -> torch.Tensor:
    """Grouped-query attention, plain unblocked path in fp32.

    q: (B, Sq, Hq, dh);  k/v: (B, Skv, Hkv, dh) with Hq = G·Hkv.
    q_offset: absolute position of q[0] (decode: the cache write position).
    kv_valid_len: optional (B,) count of valid cache slots (decode masking).
    """
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    dev = q.device
    qf = q.float() / math.sqrt(dh)
    # (B, Hkv, G, Sq, dh) x (B, Hkv, Skv, dh) -> (B, Hkv, G, Sq, Skv)
    qf = qf.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    if logits_soft_cap is not None:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    mask = None
    if causal:
        qpos = torch.arange(sq, device=dev) + q_offset
        kpos = torch.arange(skv, device=dev)
        mask = (kpos[None, :] <= qpos[:, None])[None, None, None]  # (1, 1, 1, Sq, Skv)
    if kv_valid_len is not None:
        vmask = torch.arange(skv, device=dev)[None, :] < kv_valid_len.to(dev)[:, None]  # (B, Skv)
        vmask = vmask[:, None, None, None, :]
        mask = vmask if mask is None else (mask & vmask)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """LLaMA-family gated MLP: down( silu(x·Wg) ⊙ (x·Wu) )."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (..., V), labels (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if valid is not None:
        v = valid.float()
        return (nll * v).sum() / torch.clamp(v.sum(), min=1.0)
    return nll.mean()
