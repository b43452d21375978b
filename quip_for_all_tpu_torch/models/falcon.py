"""Falcon family decoder in PyTorch — counterpart of
``quip_for_all_tpu/models/falcon.py``: the fused query_key_value in HF's
grouped layout (rows (kv_group, {q_0..q_per_group-1, k, v}, head_dim):
multi-query falcon-7b, one group, and the new decoder's KV groups), full
rotary, the parallel block off one input LayerNorm, the sequential
variant, and the new decoder's parallel block off ``ln_attn`` /
``ln_mlp``; the head tied to ``word_embeddings``. The MLP's GELU is the
tanh form, as in the JAX package (HF's Falcon uses the exact one).
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import sdpa_cache_layout, update_kv_cache
from .config import ModelConfig
from .gpt2 import gelu, layer_norm
from .llama import apply_rope, linear_apply
from .tree import LinearSpec, NormSpec, TableSpec


def split_fused_qkv(cfg: ModelConfig, qkv: torch.Tensor):
    """HF Falcon fused layout -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    B, S = qkv.shape[:2]
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    per = H // KV
    g = qkv.reshape(B, S, KV, per + 2, hd)
    q = g[..., :per, :].reshape(B, S, H, hd)
    return q, g[..., per, :], g[..., per + 1, :]


def attention(cfg: ModelConfig, attn_p, x, cos, sin, kv_cache,
              cache_position, attn_mask, linear_kw, attn_window=None,
              captures=None):
    if captures is not None:
        captures["qkv"] = x
    qkv = linear_apply(attn_p["query_key_value"], x, **linear_kw)
    q, k, v = split_fused_qkv(cfg, qkv)
    q, k = apply_rope(q, k, cos, sin)
    k, v, new_cache = update_kv_cache(kv_cache, k, v, cache_position)
    # multi-query / GQA heads are grouped inside sdpa_cache_layout (the
    # cache is never repeated)
    ctx = sdpa_cache_layout(q, k, v, attn_mask, x.dtype,
                            attn_window=attn_window)
    if captures is not None:
        captures["o"] = ctx
    return linear_apply(attn_p["dense"], ctx, **linear_kw), new_cache


def block_apply(cfg: ModelConfig, blk, x, cos=None, sin=None,
                kv_cache=None, cache_position=None, attn_mask=None,
                linear_kw: Optional[dict] = None, attn_window=None,
                capture: bool = False):
    """(x, new_cache), or with ``capture`` (x, new_cache, captures): the
    inputs of the qkv, o, fc1 and fc2 groups."""
    linear_kw = linear_kw or {}
    caps = {} if capture else None

    def mlp(h):
        m = gelu(linear_apply(blk["mlp"]["dense_h_to_4h"], h, **linear_kw))
        if capture:
            caps.update(fc1=h, fc2=m)
        return linear_apply(blk["mlp"]["dense_4h_to_h"], m, **linear_kw)

    def attn(h):
        return attention(cfg, blk["self_attention"], h, cos, sin, kv_cache,
                         cache_position, attn_mask, linear_kw, attn_window,
                         caps)

    eps = cfg.rms_norm_eps
    if cfg.parallel_dual_ln:
        # new decoder architecture (falcon-40B/180B): parallel residual
        # with separate attention / MLP input norms
        a, new_cache = attn(layer_norm(blk["ln_attn"], x, eps))
        x = x + a + mlp(layer_norm(blk["ln_mlp"], x, eps))
    elif cfg.use_parallel_residual:   # parallel_attn: one shared LN
        h = layer_norm(blk["input_layernorm"], x, eps)
        a, new_cache = attn(h)
        x = x + a + mlp(h)
    else:
        a, new_cache = attn(layer_norm(blk["input_layernorm"], x, eps))
        x = x + a
        x = x + mlp(layer_norm(blk["post_attention_layernorm"], x, eps))
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
    """The tree of ``init_falcon_params`` (``models/tree.py``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    ln = NormSpec(D, True)

    def block():
        blk = {
            "self_attention": {
                "query_key_value": LinearSpec((H + 2 * KV) * hd, D, False),
                "dense": LinearSpec(D, H * hd, False)},
            "mlp": {"dense_h_to_4h": LinearSpec(I, D, False),
                    "dense_4h_to_h": LinearSpec(D, I, False)},
        }
        if cfg.parallel_dual_ln:
            blk["ln_attn"] = ln
            blk["ln_mlp"] = ln
        else:
            blk["input_layernorm"] = ln
            if not cfg.use_parallel_residual:
                blk["post_attention_layernorm"] = ln
        return blk

    return {
        "word_embeddings": TableSpec(cfg.vocab_size, D),
        "layers": [block() for _ in range(cfg.num_hidden_layers)],
        "ln_f": ln,
    }


def init_falcon_params(cfg: ModelConfig, seed: int = 0,
                       dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_falcon_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
