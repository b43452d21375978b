"""OPT family decoder in PyTorch — counterpart of
``quip_for_all_tpu/models/opt.py``: learned positions at HF's offset of 2,
pre-LayerNorm blocks, separate q/k/v/out_proj, a ReLU fc1/fc2 MLP, biases
everywhere and the head tied to ``embed_tokens``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import sdpa_cache_layout, update_kv_cache
from .config import ModelConfig
from .gpt2 import layer_norm
from .llama import linear_apply
from .tree import LinearSpec, NormSpec, TableSpec

POS_OFFSET = 2   # HF OPTLearnedPositionalEmbedding offset


def attention(cfg: ModelConfig, attn_p, x, kv_cache, cache_position,
              attn_mask, linear_kw, attn_window=None, captures=None):
    B, S, D = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    if captures is not None:
        captures["qkv"] = x
    q = linear_apply(attn_p["q_proj"], x, **linear_kw).reshape(B, S, H, hd)
    k = linear_apply(attn_p["k_proj"], x, **linear_kw).reshape(B, S, H, hd)
    v = linear_apply(attn_p["v_proj"], x, **linear_kw).reshape(B, S, H, hd)
    k, v, new_cache = update_kv_cache(kv_cache, k, v, cache_position)
    ctx = sdpa_cache_layout(q, k, v, attn_mask, x.dtype,
                            attn_window=attn_window)
    if captures is not None:
        captures["o"] = ctx
    return linear_apply(attn_p["out_proj"], ctx, **linear_kw), new_cache


def block_apply(cfg: ModelConfig, blk, x, cos=None, sin=None,
                kv_cache=None, cache_position=None, attn_mask=None,
                linear_kw: Optional[dict] = None, attn_window=None,
                capture: bool = False):
    """(x, new_cache), or with ``capture`` (x, new_cache, captures): the
    inputs of the qkv, o, fc1 and fc2 groups."""
    linear_kw = linear_kw or {}
    caps = {} if capture else None
    h = layer_norm(blk["self_attn_layer_norm"], x, cfg.rms_norm_eps)
    a, new_cache = attention(cfg, blk["self_attn"], h, kv_cache,
                             cache_position, attn_mask, linear_kw,
                             attn_window, caps)
    x = x + a
    h = layer_norm(blk["final_layer_norm"], x, cfg.rms_norm_eps)
    m = torch.relu(linear_apply(blk["fc1"], h, **linear_kw))
    x = x + linear_apply(blk["fc2"], m, **linear_kw)
    if capture:
        caps.update(fc1=h, fc2=m)
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
    """The tree of ``init_opt_params`` (``models/tree.py``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    ln = NormSpec(D, True)
    return {
        "embed_tokens": TableSpec(cfg.vocab_size, D),
        "embed_positions": TableSpec(
            cfg.max_position_embeddings + POS_OFFSET, D),
        "layers": [
            {"self_attn_layer_norm": ln, "final_layer_norm": ln,
             "self_attn": {k: LinearSpec(D, D, True)
                           for k in ("q_proj", "k_proj", "v_proj",
                                     "out_proj")},
             "fc1": LinearSpec(I, D, True), "fc2": LinearSpec(D, I, True)}
            for _ in range(cfg.num_hidden_layers)],
        "final_layer_norm": ln,
    }


def init_opt_params(cfg: ModelConfig, seed: int = 0,
                    dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_opt_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
