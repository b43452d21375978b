"""Phi family decoder (phi-1, phi-1.5, phi-2) in PyTorch — counterpart of
``quip_for_all_tpu/models/phi.py``: separate q/k/v and ``dense``, partial
rotary from ``partial_rotary_factor`` (half-split, GPT-NeoX's), the
parallel block off a single LayerNorm, biases everywhere and an untied
``lm_head`` with a bias.
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import sdpa_cache_layout, update_kv_cache
from .config import ModelConfig
from .gpt2 import gelu, layer_norm
from .gpt_neox import _apply_partial_rope, rotary_dims
from .llama import linear_apply
from .tree import LinearSpec, NormSpec, TableSpec


def attention(cfg: ModelConfig, attn_p, x, cos, sin, kv_cache,
              cache_position, attn_mask, linear_kw, attn_window=None,
              captures=None):
    B, S, D = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    if captures is not None:
        captures["qkv"] = x
    q = linear_apply(attn_p["q_proj"], x, **linear_kw).reshape(B, S, H, hd)
    k = linear_apply(attn_p["k_proj"], x, **linear_kw).reshape(B, S, H, hd)
    v = linear_apply(attn_p["v_proj"], x, **linear_kw).reshape(B, S, H, hd)
    q, k = _apply_partial_rope(q, k, cos, sin, rotary_dims(cfg))
    k, v, new_cache = update_kv_cache(kv_cache, k, v, cache_position)
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
    h = layer_norm(blk["input_layernorm"], x, cfg.rms_norm_eps)
    a, new_cache = attention(cfg, blk["self_attn"], h, cos, sin, kv_cache,
                             cache_position, attn_mask, linear_kw,
                             attn_window, caps)
    m = gelu(linear_apply(blk["mlp"]["fc1"], h, **linear_kw))
    y = linear_apply(blk["mlp"]["fc2"], m, **linear_kw)
    if capture:
        caps.update(fc1=h, fc2=m)
        return x + a + y, new_cache, caps
    return x + a + y, new_cache                # parallel residual


def model_apply(cfg: ModelConfig, params, input_ids, positions=None,
                kv_caches=None, cache_position=None, attn_mask=None,
                linear_kw=None, dtype=torch.float32, attn_window=None):
    from .registry import decoder_apply
    return decoder_apply(cfg, params, block_apply, input_ids, positions,
                         kv_caches, cache_position, attn_mask, linear_kw,
                         dtype, attn_window)


def param_skeleton(cfg: ModelConfig) -> dict:
    """The tree of ``init_phi_params`` (``models/tree.py``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    ln = NormSpec(D, True)
    return {
        "embed_tokens": TableSpec(cfg.vocab_size, D),
        "layers": [
            {"input_layernorm": ln,
             "self_attn": {k: LinearSpec(D, D, True)
                           for k in ("q_proj", "k_proj", "v_proj",
                                     "dense")},
             "mlp": {"fc1": LinearSpec(I, D, True),
                     "fc2": LinearSpec(D, I, True)}}
            for _ in range(cfg.num_hidden_layers)],
        "final_layernorm": ln,
        "lm_head": LinearSpec(cfg.vocab_size, D, True),
    }


def init_phi_params(cfg: ModelConfig, seed: int = 0,
                    dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_phi_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
