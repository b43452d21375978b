"""GPT-NeoX family decoder (Pythia, GPT-NeoX-20B) in PyTorch — counterpart
of ``quip_for_all_tpu/models/gpt_neox.py``: the fused query_key_value with
HF's per-head interleaved rows (its output reshapes to (B, S, H, 3, hd)),
partial rotary over ``rotary_dims`` (half-split), parallel or sequential
residual, LayerNorm with a bias and the untied ``embed_out`` head.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .common import sdpa_cache_layout, update_kv_cache
from .config import ModelConfig
from .gpt2 import gelu, layer_norm
from .llama import _inv_freq, _rotate_half, linear_apply
from .tree import LinearSpec, NormSpec, TableSpec


def rotary_dims(cfg: ModelConfig) -> int:
    d = int(cfg.head_dim * cfg.rotary_pct)
    return d - d % 2


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin over the rotary sub-dimension, half-split layout (HF
    GPTNeoXRotaryEmbedding)."""
    inv = _inv_freq(rotary_dims(cfg), cfg.rope_theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_partial_rope(q, k, cos, sin, rot: int):
    # q, k: (B, S, H, hd); rotate the first `rot` dims only
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q_r, q_p = q[..., :rot], q[..., rot:]
    k_r, k_p = k[..., :rot], k[..., rot:]
    q_r = q_r * cos.to(q.dtype) + _rotate_half(q_r) * sin.to(q.dtype)
    k_r = k_r * cos.to(k.dtype) + _rotate_half(k_r) * sin.to(k.dtype)
    return torch.cat([q_r, q_p], -1), torch.cat([k_r, k_p], -1)


def attention(cfg: ModelConfig, attn_p, x, cos, sin, kv_cache,
              cache_position, attn_mask, linear_kw, attn_window=None,
              captures=None, attend: Optional[Callable] = None):
    """(out, new_cache); ``attend`` as ``models/llama.py`` ``attention``
    takes it."""
    B, S, D = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    if captures is not None:
        captures["qkv"] = x
    qkv = linear_apply(attn_p["query_key_value"], x, **linear_kw)
    qkv = qkv.reshape(B, S, H, 3, hd)          # HF interleaved layout
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    q, k = _apply_partial_rope(q, k, cos, sin, rotary_dims(cfg))
    if attend is not None:
        return linear_apply(attn_p["dense"], attend(q, k, v),
                            **linear_kw), None
    k, v, new_cache = update_kv_cache(kv_cache, k, v, cache_position)
    ctx = sdpa_cache_layout(q, k, v, attn_mask, x.dtype,
                            attn_window=attn_window)
    if captures is not None:
        captures["o"] = ctx
    return linear_apply(attn_p["dense"], ctx, **linear_kw), new_cache


def block_apply(cfg: ModelConfig, blk, x, cos=None, sin=None,
                kv_cache=None, cache_position=None, attn_mask=None,
                linear_kw: Optional[dict] = None, attn_window=None,
                capture: bool = False, attend: Optional[Callable] = None):
    """(x, new_cache), or with ``capture`` (x, new_cache, captures): the
    inputs of the qkv, o, fc1 and fc2 groups; ``attend`` as ``attention``
    takes it."""
    linear_kw = linear_kw or {}
    caps = {} if capture else None
    h = layer_norm(blk["input_layernorm"], x, cfg.rms_norm_eps)
    a, new_cache = attention(cfg, blk["attention"], h, cos, sin, kv_cache,
                             cache_position, attn_mask, linear_kw,
                             attn_window, caps, attend)

    def mlp(h):
        m = gelu(linear_apply(blk["mlp"]["dense_h_to_4h"], h, **linear_kw))
        if capture:
            caps.update(fc1=h, fc2=m)
        return linear_apply(blk["mlp"]["dense_4h_to_h"], m, **linear_kw)

    if cfg.use_parallel_residual:
        h2 = layer_norm(blk["post_attention_layernorm"], x,
                        cfg.rms_norm_eps)
        x = x + a + mlp(h2)
    else:
        x = x + a
        h2 = layer_norm(blk["post_attention_layernorm"], x,
                        cfg.rms_norm_eps)
        x = x + mlp(h2)
    if capture:
        return x, new_cache, caps
    return x, new_cache


def model_apply(cfg: ModelConfig, params, input_ids, positions=None,
                kv_caches=None, cache_position=None, attn_mask=None,
                linear_kw=None, dtype=torch.float32, attn_window=None):
    from .registry import decoder_apply
    return decoder_apply(cfg, params, block_apply, input_ids, positions,
                         kv_caches, cache_position, attn_mask, linear_kw,
                         dtype, attn_window)


def param_skeleton(cfg: ModelConfig) -> dict:
    """The tree of ``init_gpt_neox_params`` (``models/tree.py``)."""
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    ln = NormSpec(D, True)
    return {
        "embed_in": TableSpec(V, D),
        "layers": [
            {"input_layernorm": ln, "post_attention_layernorm": ln,
             "attention": {"query_key_value": LinearSpec(3 * D, D, True),
                           "dense": LinearSpec(D, D, True)},
             "mlp": {"dense_h_to_4h": LinearSpec(I, D, True),
                     "dense_4h_to_h": LinearSpec(D, I, True)}}
            for _ in range(cfg.num_hidden_layers)],
        "final_layer_norm": ln,
        "embed_out": LinearSpec(V, D, False),
    }


def init_gpt_neox_params(cfg: ModelConfig, seed: int = 0,
                         dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_gpt_neox_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
