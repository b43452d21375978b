"""Legacy QWen (Qwen-1) decoder in PyTorch — counterpart of
``quip_for_all_tpu/models/qwen.py``: RMSNorm blocks ``ln_1`` / ``ln_2``,
one fused biased qkv linear ``attn.c_attn`` run through llama's attention
as its ``W_pack`` (rows [q; k; v]), the out-projection ``attn.c_proj``,
and the MLP ``c_proj(w1(x) * silu(w2(x)))`` (w1 the up projection, w2 the
gate). ``fuse_for_inference`` fuses w1/w2, one capture group, into one
launch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.qlinear import fuse_qlinears
from .config import ModelConfig
from .llama import _sharable, attention, linear_apply, rms_norm
from .tree import FamilyModel, LinearSpec, NormSpec, TableSpec


def _attn_alias(attn_p) -> dict:
    """c_attn as llama attention's W_pack, c_proj as its o_proj."""
    return {"W_pack": attn_p["c_attn"], "o_proj": attn_p["c_proj"]}


def mlp_apply(mlp_p, x: torch.Tensor, linear_kw: dict,
              captures: Optional[dict] = None) -> torch.Tensor:
    if captures is not None:
        captures["fc1"] = x
    if "w12_proj" in mlp_p:      # fused single-launch w1/w2 (inference)
        a1, a2 = mlp_p["w12_proj"](x, **linear_kw)
    else:
        a1 = linear_apply(mlp_p["w1"], x, **linear_kw)     # up
        a2 = linear_apply(mlp_p["w2"], x, **linear_kw)     # gate
    h = a1 * F.silu(a2)
    if captures is not None:
        captures["fc2"] = h
    return linear_apply(mlp_p["c_proj"], h, **linear_kw)


def block_apply(cfg: ModelConfig, blk, x: torch.Tensor, cos, sin,
                kv_cache=None, cache_position=None, attn_mask=None,
                linear_kw: Optional[dict] = None,
                attn_window: Optional[int] = None, capture: bool = False):
    """(x, new_cache), or with ``capture`` (x, new_cache, captures): the
    inputs of the qkv, o, fc1 and fc2 groups."""
    linear_kw = linear_kw or {}
    caps = {} if capture else None
    h = rms_norm(blk["ln_1"].weight, x, cfg.rms_norm_eps)
    attn_out, new_cache = attention(cfg, _attn_alias(blk["attn"]), h, cos,
                                    sin, kv_cache, cache_position,
                                    attn_mask, linear_kw, attn_window, caps)
    x = x + attn_out
    h = rms_norm(blk["ln_2"].weight, x, cfg.rms_norm_eps)
    x = x + mlp_apply(blk["mlp"], h, linear_kw, caps)
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


def fuse_for_inference(cfg: ModelConfig, model: FamilyModel
                       ) -> FamilyModel:
    """c_attn is already one launch; w1/w2 share their left transform and
    SU (one capture group), so they fuse into ``w12_proj``, as llama's
    gate/up do. Returns a new model sharing every other submodule with
    ``model``."""
    out = FamilyModel(dict(model.items()))
    layers = []
    for src in model["layers"]:
        blk = nn.ModuleDict(dict(src.items()))
        mlp = dict(src["mlp"].items())
        duo = [mlp.get("w1"), mlp.get("w2")]
        if _sharable(duo):
            blk["mlp"] = nn.ModuleDict({"w12_proj": fuse_qlinears(duo),
                                        "c_proj": mlp["c_proj"]})
        layers.append(blk)
    out["layers"] = nn.ModuleList(layers)
    return out


def param_skeleton(cfg: ModelConfig) -> dict:
    """The tree of ``init_qwen_params`` (``models/tree.py``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, hd = cfg.num_attention_heads, cfg.head_dim
    rms = NormSpec(D, False)
    tree = {
        "wte": TableSpec(cfg.vocab_size, D),
        "layers": [
            {"ln_1": rms, "ln_2": rms,
             "attn": {"c_attn": LinearSpec(3 * H * hd, D, True),
                      "c_proj": LinearSpec(D, H * hd, False)},
             "mlp": {"w1": LinearSpec(I, D, False),
                     "w2": LinearSpec(I, D, False),
                     "c_proj": LinearSpec(D, I, False)}}
            for _ in range(cfg.num_hidden_layers)],
        "ln_f": rms,
    }
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = LinearSpec(cfg.vocab_size, D, False)
    return tree


def init_qwen_params(cfg: ModelConfig, seed: int = 0,
                     dtype=torch.float32, device="cuda"):
    """The JAX package's ``init_qwen_params`` as a ``FamilyModel``
    (``models/tree.py`` ``init_params``)."""
    from .tree import init_params
    return init_params(cfg, seed, dtype, device)
