"""Plain PyTorch versions of the flash-attention kernel: blocked online softmax.

`flash_attention_ref` is the port of `repro.kernels.flash_attention.ref`:
fp32 accumulation, −1e30 masking (−inf would NaN the running-max correction
on fully masked blocks), `kv_valid_len` (decode masking), `q_offset` and
causal block skipping.  It is what the wrapper runs for a CPU tensor, and what
`chip_smoke.py` holds the CUDA kernel against on the card.  Peak memory is
O(block_q × block_k) per head.  With `return_lse` it also gives each row's
log-sum-exp of the scaled scores, as the kernel stores it for the backward.

`flash_attention_bwd_ref` is the backward from its explicit formulas (the
backward kernel's yardstick): P = exp(S·scale − lse) on the kept pairs and 0
on the masked ones, dV = Pᵀ·dO, dS = P ∘ (dO·Vᵀ − rowsum(dO ∘ O)), dQ =
scale·dS·K, dK = scale·dSᵀ·Q, dK/dV summed over a kv head's query heads.  It
materialises the (Sq, Skv) scores of every head.

Both compute in float32, or in float64 for float64 inputs (so that
`torch.autograd.gradcheck` can hold the one to the other).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import gqa_attention

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "naive_attention_ref"]

NEG_INF = -1e30


def naive_attention_ref(q, k, v, *, causal=True, q_offset=0, kv_valid_len=None):
    """Unblocked oracle (small shapes only): the port's `gqa_attention`."""
    return gqa_attention(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)


def _kv_step(carry, qb, kb, vb, ok):
    """One online-softmax step.  qb (B, Hkv, G, bq, dh); kb/vb (B, Hkv, bk, dh);
    ok broadcastable to the scores (B, Hkv, G, bq, bk)."""
    m, l, acc = carry
    s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = corr * l + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
    return m_new, l_new, acc_new


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid_len: torch.Tensor | None = None,
    block_q: int = 512,
    block_k: int = 512,
    skip_masked_blocks: bool = False,
    return_lse: bool = False,
):
    """GQA flash attention, blocked in both q and kv.

    q: (B, Sq, Hq, dh);  k/v: (B, Skv, Hkv, dh), Hq = G·Hkv.
    q_offset: absolute position of q[0] (prefill chunk offset / decode pos).
    kv_valid_len: (B,) valid cache length mask (decode).
    skip_masked_blocks: causal block skipping — computes only the kv blocks
      at or below each q block's diagonal.
    """
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    bq, bk = min(block_q, sq), min(block_k, skv)
    nq, nk = -(-sq // bq), -(-skv // bk)
    sq_pad, skv_pad = nq * bq, nk * bk
    dev = q.device
    acc_t = _acc_dtype(q)
    qf = (q.to(acc_t) / math.sqrt(dh)).reshape(b, sq, hkv, g, dh)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, 0, 0, sq_pad - sq))
    kf = torch.nn.functional.pad(k.to(acc_t), (0, 0, 0, 0, 0, skv_pad - skv))
    vf = torch.nn.functional.pad(v.to(acc_t), (0, 0, 0, 0, 0, skv_pad - skv))
    # (B, Hkv, G, nq, bq, dh) / (B, Hkv, nk, bk, dh)
    qf = qf.permute(0, 2, 3, 1, 4).reshape(b, hkv, g, nq, bq, dh)
    kf = kf.permute(0, 2, 1, 3).reshape(b, hkv, nk, bk, dh)
    vf = vf.permute(0, 2, 1, 3).reshape(b, hkv, nk, bk, dh)

    kpos = torch.arange(skv_pad, device=dev).reshape(nk, bk)
    if kv_valid_len is not None:
        kv_ok = kpos[None] < kv_valid_len.to(dev).reshape(b, 1, 1)  # (B, nk, bk)
    else:
        kv_ok = (kpos < skv)[None].expand(b, nk, bk)

    skip = skip_masked_blocks and causal and kv_valid_len is None and sq == skv and q_offset == 0
    outs, lses = [], []
    for qi in range(nq):
        qb = qf[:, :, :, qi]  # (B, Hkv, G, bq, dh)
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        hi = min(((qi + 1) * bq + bk - 1) // bk, nk) if skip else nk
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=acc_t, device=dev)
        l = torch.zeros((b, hkv, g, bq), dtype=acc_t, device=dev)
        acc = torch.zeros((b, hkv, g, bq, dh), dtype=acc_t, device=dev)
        for ki in range(hi):
            ok = kv_ok[:, ki][:, None, None, None, :]  # (B, 1, 1, 1, bk)
            if causal:
                ok = ok & (kpos[ki][None, :] <= qpos[:, None])[None, None, None]
            m, l, acc = _kv_step((m, l, acc), qb, kf[:, :, ki], vf[:, :, ki], ok)
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.stack(outs, dim=3)  # (B, Hkv, G, nq, bq, dh)
    out = out.reshape(b, hkv, g, sq_pad, dh)[:, :, :, :sq]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.stack(lses, dim=3).reshape(b, hkv * g, sq_pad)[:, :, :sq]  # (B, Hq, Sq), h = hk·G + g
    return out, lse.contiguous()


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_bwd_ref(
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
    """(dq, dk, dv) in q's type for the output cotangent `dout` of
    `flash_attention(q, k, v)`, from its output `o` and `lse` (B, Hq, Sq).
    A row whose keys are all masked adds no gradient."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    acc_t = _acc_dtype(q)
    scale = 1.0 / math.sqrt(dh)

    def heads(t):  # (B, S, Hq, dh) → (B, Hkv, G, S, dh)
        return t.to(acc_t).reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4)

    qf, of, df = heads(q), heads(o), heads(dout)
    kf, vf = k.to(acc_t).permute(0, 2, 1, 3), v.to(acc_t).permute(0, 2, 1, 3)  # (B, Hkv, Skv, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        ok = torch.arange(skv, device=q.device)[None, :] <= qpos[:, None]
    p = torch.where(ok, torch.exp(s - lse.to(acc_t).reshape(b, hkv, g, sq)[..., None]), torch.zeros((), dtype=acc_t))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, df)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", df, vf)
    ds = p * (dp - (df * of).sum(-1, keepdim=True))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(q.dtype), dv.permute(0, 2, 1, 3).to(q.dtype)
