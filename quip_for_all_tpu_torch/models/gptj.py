"""GPT-J family decoder (gpt-j-6b) in PyTorch — counterpart of
``quip_for_all_tpu/models/gptj.py``: interleaved partial rotary ("rotate
every two": the pairs (x[2i], x[2i+1]) of the first ``rotary_dim`` dims),
the parallel block off a single ``ln_1``, q/k/v/out without a bias,
fc_in/fc_out with one, and an untied ``lm_head`` with a bias.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import sdpa_cache_layout, update_kv_cache
from .config import ModelConfig
from .gpt2 import gelu, layer_norm
from .gpt_neox import rotary_dims
from .llama import _inv_freq, linear_apply
from .tree import LinearSpec, NormSpec, TableSpec


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin over the rotary sub-dimension, each frequency repeated for
    its (2i, 2i+1) pair (HF GPT-J's sinusoidal positions)."""
    inv = _inv_freq(rotary_dims(cfg), cfg.rope_theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    emb = torch.stack([ang, ang], dim=-1).reshape(*ang.shape[:-1], -1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_every_two(x):
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _apply_interleaved_rope(q, k, cos, sin, rot: int):
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q_r, q_p = q[..., :rot], q[..., rot:]
    k_r, k_p = k[..., :rot], k[..., rot:]
    q_r = q_r * cos.to(q.dtype) + _rotate_every_two(q_r) * sin.to(q.dtype)
    k_r = k_r * cos.to(k.dtype) + _rotate_every_two(k_r) * sin.to(k.dtype)
    return torch.cat([q_r, q_p], -1), torch.cat([k_r, k_p], -1)


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
    q, k = _apply_interleaved_rope(q, k, cos, sin, rotary_dims(cfg))
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
    h = layer_norm(blk["ln_1"], x, cfg.rms_norm_eps)
    a, new_cache = attention(cfg, blk["attn"], h, cos, sin, kv_cache,
                             cache_position, attn_mask, linear_kw,
                             attn_window, caps)
    m = gelu(linear_apply(blk["mlp"]["fc_in"], h, **linear_kw))
    y = linear_apply(blk["mlp"]["fc_out"], m, **linear_kw)
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
    """The tree of ``init_gptj_params`` (``models/tree.py``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    return {
        "wte": TableSpec(cfg.vocab_size, D),
        "layers": [
            {"ln_1": NormSpec(D, True),
             "attn": {k: LinearSpec(D, D, False)
                      for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
             "mlp": {"fc_in": LinearSpec(I, D, True),
                     "fc_out": LinearSpec(D, I, True)}}
            for _ in range(cfg.num_hidden_layers)],
        "ln_f": NormSpec(D, True),
        "lm_head": LinearSpec(cfg.vocab_size, D, True),
    }


def init_gptj_params(cfg: ModelConfig, seed: int = 0,
                     dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_gptj_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
