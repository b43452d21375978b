"""Static KV caches and cache-layout attention — counterpart of
``quip_for_all_tpu/models/common.py``.

A cache is a preallocated (B, T, KV, hd) tensor per layer and per k/v, or
a ``QuantKVCache`` (int8 codes and per-position f32 scales). Unlike the
JAX package, whose arrays are immutable, the port writes new positions IN
PLACE (no copy of the whole slab per token).

A write position is a host ``int`` (checked against the cache length), a
0-d device tensor (every row at one offset: graphed single-sequence
decode) or a (B,) device tensor (each row at its own offset: continuous
batching). Tensor positions are never read back to the host and follow
``jax.lax.dynamic_update_slice``: a negative start counts from the end,
then the start is clamped into [0, T - S], so a write never leaves the
cache (the serving engine parks idle rows in a scratch tail on that
rule).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

Position = Union[int, torch.Tensor]


def attn_bucket(need: int, cache_len: int) -> int:
    """Smallest decode-attention bucket (256 · 2^k, capped at cache_len)
    covering ``need`` cache slots."""
    w = 256
    while w < min(need, cache_len):
        w *= 2
    return min(w, cache_len)


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache slab: per-(slot, position, head) absmax scaling. Half
    the attention reads of a bf16 cache; it is dequantized after the
    attention-window slice, so only the attended prefix is converted."""
    data: torch.Tensor       # (B, T, KV, hd) int8
    scale: torch.Tensor      # (B, T, KV, 1) f32


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, hd) float -> (int8 codes, f32 scale). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.to(torch.float32)
    s = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def kv_materialize(kv, dtype) -> torch.Tensor:
    """QuantKVCache | Tensor -> dense tensor in ``dtype``."""
    if isinstance(kv, QuantKVCache):
        return (kv.data.to(torch.float32) * kv.scale).to(dtype)
    return kv.to(dtype) if kv.dtype != dtype else kv


def kv_window(kv, W: int):
    """Static prefix slice [:, :W] on either cache representation."""
    if isinstance(kv, QuantKVCache):
        if W >= kv.data.shape[1]:
            return kv
        return QuantKVCache(kv.data[:, :W], kv.scale[:, :W])
    return kv[:, :W] if W < kv.shape[1] else kv


def _clamped(start: Position, T: int, size: int) -> Position:
    """``dynamic_slice``'s start: negative counts from the end, then
    clamped into [0, T - size]; on the device for a tensor."""
    if isinstance(start, int):
        return min(max(start + T if start < 0 else start, 0), T - size)
    return torch.clamp(torch.where(start < 0, start + T, start), 0, T - size)


def _dyn_slice(t: torch.Tensor, start: Position, size: int) -> torch.Tensor:
    s = _clamped(start, t.shape[1], size)
    if isinstance(s, int):
        return t[:, s:s + size]
    return t.index_select(1, s + torch.arange(size, device=t.device))


def kv_dyn_slice(kv, start: Position, size: int):
    """``dynamic_slice_in_dim`` on the time axis, both representations (a
    tensor start is clamped on the device)."""
    if isinstance(kv, QuantKVCache):
        return QuantKVCache(_dyn_slice(kv.data, start, size),
                            _dyn_slice(kv.scale, start, size))
    return _dyn_slice(kv, start, size)


def kv_len(kv) -> int:
    return (kv.data if isinstance(kv, QuantKVCache) else kv).shape[1]


def _write_slab(c: torch.Tensor, x: torch.Tensor, cp: Position
                ) -> torch.Tensor:
    B, T = c.shape[:2]
    S = x.shape[1]
    x = x.to(c.dtype)
    if isinstance(cp, int):
        c[:, cp:cp + S] = x
        return c
    steps = torch.arange(S, device=c.device)
    if cp.dim() == 0:
        c.index_copy_(1, _clamped(cp, T, S) + steps, x)
        return c
    # one start per row, each clamped as the vmapped dynamic update is
    idx = _clamped(cp, T, S)[:, None] + steps                   # (B, S)
    rows = torch.arange(B, device=c.device)[:, None]
    c.index_put_((rows, idx), x)
    return c


def write_kv(cache, x: torch.Tensor, cp: Position):
    """Write new (B, S, KV, hd) float k-or-v into either cache kind at
    ``cp`` (see the module docstring); returns the cache."""
    if isinstance(cp, bool) or not isinstance(cp, (int, torch.Tensor)):
        raise TypeError(f"cache_position must be an int or a tensor, got "
                        f"{type(cp).__name__}")
    T, S = kv_len(cache), x.shape[1]
    if isinstance(cp, int) and not 0 <= cp <= T - S:
        raise ValueError(f"write at {cp}+{S} past cache length {T}")
    if isinstance(cp, torch.Tensor) and cp.dim() not in (0, 1):
        raise ValueError(f"cache_position tensor of shape {tuple(cp.shape)}"
                         " (want 0-d or (B,))")
    if isinstance(cache, QuantKVCache):
        q, s = kv_quantize(x)
        _write_slab(cache.data, q, cp)
        _write_slab(cache.scale, s, cp)
        return cache
    return _write_slab(cache, x, cp)


def update_kv_cache(kv_cache, k: torch.Tensor, v: torch.Tensor,
                    cache_position: Position):
    """Write the new k/v (B, S, KV, hd) into the static cache at
    ``cache_position``. Returns (k, v, new_cache): k/v the full caches
    (possibly QuantKVCache) when caching, the inputs when kv_cache is
    None."""
    if kv_cache is None:
        return k, v, None
    ck = write_kv(kv_cache[0], k, cache_position)
    cv = write_kv(kv_cache[1], v, cache_position)
    return ck, cv, (ck, cv)


def sdpa_cache_layout(q: torch.Tensor, k, v, attn_mask: torch.Tensor,
                      out_dtype, attn_window: Optional[int] = None
                      ) -> torch.Tensor:
    """Attention with k/v in cache layout (B, T, KV, hd), dense or
    ``QuantKVCache``; q (B, S, H, hd); returns (B, S, H*hd).

    Written as the JAX package's explicit products: f32 scores (exact
    products of the inputs, f32 sums), a -1e9 additive mask, f32 softmax,
    probabilities cast to ``out_dtype`` and a value product accumulated in
    f32. ``attn_window`` (static) promises every query position is <
    attn_window, so only that cache prefix is read; an int8 cache is
    dequantized (to q's dtype, as JAX does) after that slice. GQA groups
    the query heads over their kv head (query head h uses kv head
    h // (H // KV)) instead of repeating the cache."""
    if attn_window is not None and attn_window < kv_len(k):
        k = kv_window(k, attn_window)
        v = kv_window(v, attn_window)
        attn_mask = attn_mask[..., :attn_window]
    k = kv_materialize(k, q.dtype)
    v = kv_materialize(v, q.dtype)
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
