"""Static KV cache and cache-layout attention — counterpart of the bf16
parts of ``quip_for_all_tpu/models/common.py``.

The cache is a preallocated (B, S_max, KV, hd) tensor per layer and per
k/v. Unlike the JAX package, whose arrays are immutable, the port writes
new positions IN PLACE (no copy of the whole slab per token). The int8
cache (``QuantKVCache``) is queued for slice 2.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def kv_window(kv: torch.Tensor, W: int) -> torch.Tensor:
    """Static prefix slice [:, :W] of the time axis."""
    return kv[:, :W] if W < kv.shape[1] else kv


def _write_slab(c: torch.Tensor, x: torch.Tensor, cp: int) -> torch.Tensor:
    c[:, cp:cp + x.shape[1]] = x.to(c.dtype)
    return c


def write_kv(cache: torch.Tensor, x: torch.Tensor, cp: int) -> torch.Tensor:
    """Write new (B, S, KV, hd) k-or-v into the cache at position cp (a
    host integer: the decode loop knows every position statically)."""
    if not isinstance(cp, int):
        raise TypeError("cache_position must be a host int")
    if cp + x.shape[1] > cache.shape[1]:
        raise ValueError(f"write at {cp}+{x.shape[1]} past cache length "
                         f"{cache.shape[1]}")
    return _write_slab(cache, x, cp)


def sdpa_cache_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      attn_mask: torch.Tensor, out_dtype,
                      attn_window: Optional[int] = None) -> torch.Tensor:
    """Attention with k/v in cache layout (B, T, KV, hd); q (B, S, H, hd);
    returns (B, S, H*hd).

    Written as the JAX package's explicit products: f32 scores (exact
    products of the bf16 inputs, f32 sums), a -1e9 additive mask, f32
    softmax, probabilities cast to ``out_dtype`` and a value product
    accumulated in f32. ``attn_window`` (static) promises every query
    position is < attn_window, so only that cache prefix is read. GQA
    groups the query heads over their kv head (query head h uses kv head
    h // (H // KV)) instead of repeating the cache."""
    if attn_window is not None and attn_window < k.shape[1]:
        k = kv_window(k, attn_window)
        v = kv_window(v, attn_window)
        attn_mask = attn_mask[..., :attn_window]
    B, S, H, hd = q.shape
    KV, T = k.shape[2], k.shape[1]
    rep = H // KV
    # (B, KV, rep*S, hd); rep == 1 is the plain multi-head case
    qg = (q.reshape(B, S, KV, rep, hd).permute(0, 2, 3, 1, 4)
          .reshape(B, KV, rep * S, hd))
    kt = k.permute(0, 2, 3, 1).to(torch.float32)             # (B, KV, hd, T)
    scores = torch.matmul(qg.to(torch.float32), kt) / math.sqrt(hd)
    scores = scores.reshape(B, KV, rep, S, T) + attn_mask[:, :, None]
    probs = (torch.softmax(scores, dim=-1).to(out_dtype)
             .reshape(B, KV, rep * S, T))
    vt = v.permute(0, 2, 1, 3).to(torch.float32)             # (B, KV, T, hd)
    ctx = torch.matmul(probs.to(torch.float32), vt).to(out_dtype)
    return (ctx.reshape(B, KV, rep, S, hd).permute(0, 3, 1, 2, 4)
            .reshape(B, S, H * hd))
