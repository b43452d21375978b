"""GPT-2 family decoder in PyTorch — counterpart of
``quip_for_all_tpu/models/gpt2.py``: LayerNorm with a bias (in f32, cast
back to x's dtype), learned absolute positions (``wpe``, gathered by the
(B, S) position tensor), one fused qkv projection (``c_attn``), a
tanh-approximate GELU MLP and the head tied to ``wte``. The forward
functions keep the JAX names; ``model_apply`` is the families' shared
``models/registry.py`` ``decoder_apply``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import sdpa_cache_layout, update_kv_cache
from .config import ModelConfig
from .llama import linear_apply
from .tree import LinearSpec, NormSpec, TableSpec


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p.weight.to(torch.float32)
    if p.bias is not None:
        y = y + p.bias.to(torch.float32)
    return y.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, the form every JAX family uses."""
    return F.gelu(x, approximate="tanh")


def attention(cfg: ModelConfig, attn_p, x, kv_cache, cache_position,
              attn_mask, linear_kw, attn_window=None, captures=None):
    B, S, D = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    if captures is not None:
        captures["qkv"] = x
    qkv = linear_apply(attn_p["c_attn"], x, **linear_kw)     # (B,S,3D)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, H, hd)
    v = v.reshape(B, S, H, hd)
    k, v, new_cache = update_kv_cache(kv_cache, k, v, cache_position)
    ctx = sdpa_cache_layout(q, k, v, attn_mask, x.dtype,
                            attn_window=attn_window)
    if captures is not None:
        captures["o"] = ctx
    return linear_apply(attn_p["c_proj"], ctx, **linear_kw), new_cache


def block_apply(cfg: ModelConfig, blk, x, cos=None, sin=None,
                kv_cache=None, cache_position=None, attn_mask=None,
                linear_kw: Optional[dict] = None, attn_window=None,
                capture: bool = False):
    """(x, new_cache), or with ``capture`` (x, new_cache, captures): the
    inputs of the qkv, o, fc1 and fc2 groups."""
    linear_kw = linear_kw or {}
    caps = {} if capture else None
    h = layer_norm(blk["ln_1"], x, cfg.rms_norm_eps)
    a, new_cache = attention(cfg, blk["attn"], h, kv_cache, cache_position,
                             attn_mask, linear_kw, attn_window, caps)
    x = x + a
    h = layer_norm(blk["ln_2"], x, cfg.rms_norm_eps)
    m = gelu(linear_apply(blk["mlp"]["c_fc"], h, **linear_kw))
    x = x + linear_apply(blk["mlp"]["c_proj"], m, **linear_kw)
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
    """The tree of ``init_gpt2_params`` (``models/tree.py``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    ln = NormSpec(D, True)
    return {
        "wte": TableSpec(cfg.vocab_size, D),
        "wpe": TableSpec(cfg.max_position_embeddings, D),
        "layers": [
            {"ln_1": ln, "ln_2": ln,
             "attn": {"c_attn": LinearSpec(3 * D, D, True),
                      "c_proj": LinearSpec(D, D, True)},
             "mlp": {"c_fc": LinearSpec(I, D, True),
                     "c_proj": LinearSpec(D, I, True)}}
            for _ in range(cfg.num_hidden_layers)],
        "ln_f": ln,
    }


def init_gpt2_params(cfg: ModelConfig, seed: int = 0,
                     dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_gpt2_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
