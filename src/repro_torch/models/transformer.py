"""LLaMA-family dense transformer with GQA and RoPE: forward, prefill, decode.

The port of `repro.models.transformer` for one device.  What carries over:
  * the public layout — layer-stacked weights `(L, d_in, d_out)` used as
    `x @ w`, a KV cache `{"k", "v"}` of `(L, B, max_seq, Hkv, dh)` — so the
    JAX package's params load one for one (`repro_torch.interop`);
  * the dtype steps — params in `cfg.param_dtype`, activations in `cfg.dtype`,
    fp32 norm statistics, rope and attention softmax.
What changes:
  * `lax.scan` over layers is a Python loop over the stacked tensors, split
    once a forward with `torch.unbind` (its backward is one `stack` a leaf,
    where indexing each layer would add a leaf-sized zero tensor a layer);
    `cfg.remat` (default True, as the reference) recomputes each layer in the
    backward (`torch.utils.checkpoint`, non-reentrant) when grad is on, so the
    attention forward kernel runs twice a layer in a training step; no mesh
    (`models/sharding.py` is not ported).
  * Attention of prefill and forward goes through `ops.flash_attention`
    (the CUDA kernel for a CUDA tensor; with grad on, through its autograd
    Function, whose backward is the kernel `csrc/flash_attention_bwd.cu`).
    The JAX model reaches its blocked
    reference only above `BLOCKED_ATTN_THRESHOLD · 64` and `gqa_attention`
    otherwise; both compute the same function.  In `prefill` the slot is fresh
    (pos = 0), so attention over the cache restricted to `kv_valid_len = s`
    is causal attention over the s rows just written: the port attends over
    `k.to(cache.dtype).to(q.dtype)`, which are exactly the values the JAX
    code reads back from the cache.
  * Decode stays on the plain `gqa_attention` with `kv_valid_len = pos + 1`.
  * The cache is updated in place (JAX returns a new one); the functions
    return it all the same.
  * `cast_params` keeps one `cfg.dtype` copy of every weight instead of the
    `.astype(h.dtype)` at every use: bit-identical, and a decode step then
    reads half the bytes.
  * With `cfg.moe` the FFN is `models.moe.moe_block` (`impl="local"`) on the
    normed input; `cast_params` keeps the router in its own type, because
    the router computes in float32 (a bf16 copy would change its logits).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Initializer,
    apply_rope,
    gqa_attention,
    rms_norm,
    rope_table,
    softmax_cross_entropy,
)

__all__ = ["TransformerConfig", "layer_shapes", "init_params", "cast_params", "forward", "loss_fn",
           "init_kv_cache", "decode_step", "decode_step_batched_pos", "prefill"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    rope_theta: float = 10000.0
    moe: moe_lib.MoEConfig | None = None
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = False
    attn_block_q: int = 512
    attn_block_k: int = 1024
    attn_skip_masked_blocks: bool = False
    attn_impl: str = "auto"  # ops.flash_attention's impl for prefill/forward
    remat: bool = True  # recompute each layer in the backward (forward with grad on)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def num_params(self) -> int:
        """Parameter count N for MODEL_FLOPS = 6·N·D accounting."""
        return self._count(self.moe.num_experts if self.moe is not None else 0)

    @property
    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        return self._count(self.moe.top_k if self.moe is not None else 0)

    def _count(self, experts: int) -> int:
        """Params with `experts` routed experts a layer (dense: the FFN)."""
        dh = self.head_dim
        attn = self.d_model * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * self.d_model
        if self.moe is not None:
            m = self.moe
            ffn = 3 * self.d_model * m.d_ff_expert * experts + 3 * self.d_model * m.d_ff_shared
            ffn += self.d_model * m.num_experts  # router
        else:
            ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.d_model


# ----------------------------- parameters ---------------------------------


def layer_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    d, dh = cfg.d_model, cfg.head_dim
    shapes = {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads * dh),
        "wk": (d, cfg.n_kv_heads * dh),
        "wv": (d, cfg.n_kv_heads * dh),
        "wo": (cfg.n_heads * dh, d),
        "mlp_norm": (d,),
    }
    if cfg.moe is None:
        shapes.update({"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)})
    else:
        shapes.update(moe_lib.layer_shapes(cfg.moe, d))
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Random params in the JAX package's layout, drawn from a `torch.Generator`
    seeded with `seed` on `device` (None: the card).  The draws differ from
    `jax.random`'s; to compute on the JAX package's weights, carry them over
    with `repro_torch.interop.transformer_params`."""
    ini = Initializer.seeded(seed, resolve_device(device))
    n = cfg.n_layers
    layers = {}
    for name, shape in layer_shapes(cfg).items():
        full = (n, *shape)  # always layer-stacked
        layers[name] = ini.ones(full, cfg.param_dtype) if "norm" in name else ini.fan_in(full, cfg.param_dtype)
    params = {
        "embed": ini.normal((cfg.vocab, cfg.d_model), 0.02, cfg.param_dtype),
        "layers": layers,
        "final_norm": ini.ones((cfg.d_model,), cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.fan_in((cfg.d_model, cfg.vocab), cfg.param_dtype)
    return params


def cast_params(params: dict, cfg: TransformerConfig, *, device: torch.device | None = None) -> dict:
    """The same tree with every tensor in `cfg.dtype` (and on `device`, where
    given).  Every use casts a weight to the activation type first, so
    computing on this tree is bit-identical; tensors already in that type and
    place are shared, not copied.  The MoE router is the exception: it is
    used in float32, so it keeps its type."""
    return {
        k: cast_params(v, cfg, device=device) if isinstance(v, dict)
        else v.to(device=device, dtype=v.dtype if k == "router" else cfg.dtype)
        for k, v in params.items()
    }


# ------------------------------ forward -----------------------------------


def _qkv(cfg: TransformerConfig, lp: dict, x: torch.Tensor):
    b, s, _ = x.shape
    dh = cfg.head_dim
    h = rms_norm(x, lp["attn_norm"])
    q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, dh)
    k = (h @ lp["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, dh)
    v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def _out_proj(cfg: TransformerConfig, lp: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, s = out.shape[:2]
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["wo"].to(x.dtype)


def _ffn_block(cfg: TransformerConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"])
    if cfg.moe is not None:
        return moe_lib.moe_block(cfg.moe, lp, h)
    g = h @ lp["w_gate"].to(h.dtype)
    u = h @ lp["w_up"].to(h.dtype)
    return (F.silu(g) * u) @ lp["w_down"].to(h.dtype)


def _causal_attention(cfg: TransformerConfig, q, k, v) -> torch.Tensor:
    return flash_attention(
        q, k, v, causal=True, q_offset=0, impl=cfg.attn_impl,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        skip_masked_blocks=cfg.attn_skip_masked_blocks,
    )


def _prompt_layer(cfg: TransformerConfig, x, lp, cos, sin, cache_kv=None):
    """One layer over a whole prompt from position 0; with `cache_kv` =
    (ck, cv) of (B, max_seq, Hkv, dh) the new rows are written there."""
    q, k, v = _qkv(cfg, lp, x)
    k = apply_rope(k, cos, sin)
    q = apply_rope(q, cos, sin)
    if cache_kv is not None:
        ck, cv = cache_kv
        s = x.shape[1]
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
        # what the JAX model reads back from the cache (a no-op cast when it is q's type)
        k, v = k.to(ck.dtype).to(q.dtype), v.to(cv.dtype).to(q.dtype)
    x = x + _out_proj(cfg, lp, _causal_attention(cfg, q, k, v), x)
    return x + _ffn_block(cfg, lp, x)


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _layers(params: dict, n: int) -> list[dict]:
    """Every layer's weights, each stacked leaf split once (`torch.unbind`)."""
    split = {k: torch.unbind(v, 0) for k, v in params["layers"].items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _embed(params: dict, tokens, cfg: TransformerConfig) -> torch.Tensor:
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    return emb[tokens].to(cfg.dtype)  # = embed.astype(dtype)[tokens], without casting the table


def _head(params: dict, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(cfg.dtype)


def forward(params: dict, tokens, cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V)."""
    x = _embed(params, tokens, cfg)
    cos, sin = rope_table(x.shape[1], cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layers(params, cfg.n_layers):
        if remat:
            x = checkpoint(_prompt_layer, cfg, x, lp, cos, sin, use_reentrant=False)
        else:
            x = _prompt_layer(cfg, x, lp, cos, sin)
    return _head(params, x, cfg)


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    valid = batch.get("valid")
    valid = None if valid is None else torch.as_tensor(valid, device=logits.device)
    return softmax_cross_entropy(logits, labels, valid=valid)


# ------------------------------ serving -----------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
                  device: str | torch.device | None = None) -> dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params: dict, tokens, cache: dict, cfg: TransformerConfig):
    """Prefill the cache with a full prompt from position 0 (written in
    place); returns (last_logits (B, V), cache)."""
    x = _embed(params, tokens, cfg)
    s = x.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's {cache['k'].shape[2]} positions")
    cos, sin = rope_table(s, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    for i in range(cfg.n_layers):
        x = _prompt_layer(cfg, x, _layer(params, i), cos, sin, (cache["k"][i], cache["v"][i]))
    return _head(params, x[:, -1], cfg), cache


def decode_step(params: dict, cache: dict, pos, tokens, cfg: TransformerConfig):
    """One decode step: tokens (B, 1) at absolute position `pos` (an int, the
    same for every row).  Returns (logits (B, V), cache)."""
    x = _embed(params, tokens, cfg)  # (B, 1, D)
    b = x.shape[0]
    max_seq = cache["k"].shape[2]
    pos = int(pos)
    at = min(max(pos, 0), max_seq - 1)  # where dynamic_update_slice would write
    cos_t, sin_t = rope_table(max_seq, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    cos, sin = cos_t[at:at + 1], sin_t[at:at + 1]
    valid = torch.full((b,), pos + 1, dtype=torch.long, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, lp, x)
        k = apply_rope(k, cos, sin)
        q = apply_rope(q, cos, sin)
        ck[:, at] = k[:, 0].to(ck.dtype)
        cv[:, at] = v[:, 0].to(cv.dtype)
        out = gqa_attention(q, ck, cv, causal=True, q_offset=pos, kv_valid_len=valid)
        x = x + _out_proj(cfg, lp, out, x)
        x = x + _ffn_block(cfg, lp, x)
    return _head(params, x, cfg)[:, -1], cache


def decode_step_batched_pos(params: dict, cache: dict, pos, tokens, cfg: TransformerConfig):
    """Continuous-batching decode: every slot at its own position.
    pos: (B,) absolute write positions; tokens: (B, 1)."""
    x = _embed(params, tokens, cfg)  # (B, 1, D)
    b = x.shape[0]
    max_seq = cache["k"].shape[2]
    pos = torch.as_tensor(pos, device=x.device).long()
    at = pos.clamp(0, max_seq - 1)
    rows = torch.arange(b, device=x.device)
    cos_t, sin_t = rope_table(max_seq, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    cos_b, sin_b = cos_t[at][:, None, None, :], sin_t[at][:, None, None, :]  # (B, 1, 1, half)

    def rope_at(t):  # t: (B, 1, H, dh)
        half = t.shape[-1] // 2
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos_b - t2 * sin_b, t2 * cos_b + t1 * sin_b], -1).to(t.dtype)

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, lp, x)
        q, k = rope_at(q), rope_at(k)
        ck[rows, at] = k[:, 0].to(ck.dtype)
        cv[rows, at] = v[:, 0].to(cv.dtype)
        out = gqa_attention(q, ck, cv, causal=False, kv_valid_len=pos + 1)
        x = x + _out_proj(cfg, lp, out, x)
        x = x + _ffn_block(cfg, lp, x)
    return _head(params, x, cfg)[:, -1], cache
