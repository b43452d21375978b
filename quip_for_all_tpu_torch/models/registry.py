"""Architecture registry: one functional API per model family —
counterpart of ``quip_for_all_tpu/models/registry.py``.

``get_arch(cfg)`` returns the module that implements the config's family
(``model_apply``, ``block_apply``, ``param_skeleton`` and, for QWen and the
llama family, ``fuse_for_inference``); llama, Mixtral and Baichuan resolve
to ``models/llama.py``, as in the JAX package. ``fuse_for_inference``
here fuses any family's model where its module can. The helpers below (the
embedding, rotary tables, final norm and head of each family) serve the
families' shared forward, ``decoder_apply``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig


def get_arch(cfg: ModelConfig):
    """Return the module implementing this config's family."""
    if cfg.arch == "gpt2":
        from . import gpt2
        return gpt2
    if cfg.arch == "gpt_neox":
        from . import gpt_neox
        return gpt_neox
    if cfg.arch == "opt":
        from . import opt
        return opt
    if cfg.arch == "falcon":
        from . import falcon
        return falcon
    if cfg.arch == "phi":
        from . import phi
        return phi
    if cfg.arch == "gptj":
        from . import gptj
        return gptj
    if cfg.arch == "qwen":
        from . import qwen
        return qwen
    from . import llama
    return llama


def fuse_for_inference(cfg: ModelConfig, model):
    """The family's ``fuse_for_inference`` (llama's qkv and gate/up and
    Mixtral's expert stacking, QWen's w1/w2); the other families have
    none and run unfused, as in the JAX package: ``model`` comes back as
    it is."""
    fuse = getattr(get_arch(cfg), "fuse_for_inference", None)
    return model if fuse is None else fuse(cfg, model)


def rank_config(cfg: ModelConfig, model) -> ModelConfig:
    """The config a model's blocks run with: a tensor-parallel rank's
    model (``parallel/sharding.py`` ``shard_params``) carries its own
    (its heads and MLP width), any other model runs ``cfg``."""
    return getattr(model, "tp_cfg", None) or cfg


def model_device(model) -> torch.device:
    """The device of the model's weights (its first buffer)."""
    return next(iter(model.buffers())).device


def _child(params, key: str):
    """A top-level entry of a ``FamilyModel`` or a ``LlamaModel``; None
    where it is absent."""
    if isinstance(params, nn.ModuleDict):
        return params[key] if key in params else None
    return getattr(params, key, None)


def model_layers(model):
    """The block list of a ``LlamaModel`` or a ``FamilyModel``."""
    return _child(model, "layers")


def _table(params, key: str) -> torch.Tensor:
    return _child(params, key).weight


def _learned(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rows of a learned position table. Positions past its end are
    clamped to the last row: the JAX gather there yields values nobody
    reads (a serving engine's parked rows write their pad chunk to a
    scratch tail never attended), and on a card an index past the table
    would stop the process."""
    return F.embedding(positions.clamp(max=table.shape[0] - 1), table)


def embed(cfg: ModelConfig, params, ids: torch.Tensor,
          positions: torch.Tensor, dtype) -> torch.Tensor:
    if cfg.arch == "gpt2":
        x = F.embedding(ids, _table(params, "wte")).to(dtype)
        return x + _learned(_table(params, "wpe"), positions).to(dtype)
    if cfg.arch == "gpt_neox":
        return F.embedding(ids, _table(params, "embed_in")).to(dtype)
    if cfg.arch in ("gptj", "qwen"):
        return F.embedding(ids, _table(params, "wte")).to(dtype)
    if cfg.arch == "opt":
        from .opt import POS_OFFSET
        x = F.embedding(ids, _table(params, "embed_tokens")).to(dtype)
        return x + _learned(_table(params, "embed_positions"),
                            positions + POS_OFFSET).to(dtype)
    if cfg.arch == "falcon":
        return F.embedding(ids, _table(params, "word_embeddings")).to(dtype)
    return F.embedding(ids, _table(params, "embed_tokens")).to(dtype)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.arch in ("gpt2", "opt"):
        return None, None
    if cfg.arch in ("gpt_neox", "phi"):
        from . import gpt_neox
        return gpt_neox.rope_tables(cfg, positions)
    if cfg.arch == "gptj":
        from . import gptj
        return gptj.rope_tables(cfg, positions)
    from . import llama
    return llama.rope_tables(cfg, positions)


# family -> (final norm param key, norm kind). Families absent from the
# table (llama/mixtral/baichuan) use ("norm", "rms").
_FINAL_NORM = {
    "gpt2": ("ln_f", "layer"),
    "gpt_neox": ("final_layer_norm", "layer"),
    "opt": ("final_layer_norm", "layer"),
    "falcon": ("ln_f", "layer"),
    "phi": ("final_layernorm", "layer"),
    "gptj": ("ln_f", "layer"),
    "qwen": ("ln_f", "rms"),
}

# family -> key of the tied-embedding matrix used as the output head when
# no standalone head linear exists.
_TIED_EMBED = {
    "gpt2": "wte",
    "gptj": "wte",
    "qwen": "wte",
    "falcon": "word_embeddings",
}


def final_hidden(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Apply the family's final norm to hidden states x (..., D)."""
    key, kind = _FINAL_NORM.get(cfg.arch, ("norm", "rms"))
    if kind == "layer":
        from .gpt2 import layer_norm
        return layer_norm(_child(params, key), x, cfg.rms_norm_eps)
    from .llama import rms_norm
    return rms_norm(_child(params, key).weight, x, cfg.rms_norm_eps)


def untied_head_key(cfg: ModelConfig, params) -> Optional[str]:
    """Key of the standalone output-head linear (dense or quantized), or
    None when the head is tied to the embedding."""
    key = "embed_out" if cfg.arch == "gpt_neox" else "lm_head"
    return key if _child(params, key) is not None else None


def head_logits(cfg: ModelConfig, params, h: torch.Tensor,
                linear_kw: Optional[dict] = None) -> torch.Tensor:
    """Project final-norm'd hidden states to vocabulary logits: the head
    linear, or ``h @ E.T`` in h's dtype for a tied head."""
    from .llama import linear_apply
    key = untied_head_key(cfg, params)
    if key is not None:
        return linear_apply(_child(params, key), h, **(linear_kw or {}))
    emb = _TIED_EMBED.get(cfg.arch, "embed_tokens")
    return h @ _table(params, emb).to(h.dtype).T


def decoder_apply(cfg: ModelConfig, params, block_apply,
                  input_ids: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  kv_caches: Optional[list] = None, cache_position=None,
                  attn_mask: Optional[torch.Tensor] = None,
                  linear_kw: Optional[dict] = None, dtype=torch.float32,
                  attn_window: Optional[int] = None):
    """The ``model_apply`` of the families in ``models/tree.py``: the
    embedding (with learned positions where the family has them), the
    rotary tables, the causal or cache mask, every block through the
    family's ``block_apply``, the final norm and the head — the steps of
    each JAX family's own ``model_apply``, in its order. input_ids (B, S)
    -> (logits (B, S, V), caches); caches, positions and attn_window as
    ``models/llama.py`` ``model_apply`` takes them. Nothing here reads a
    tensor back to the host, so a decode step can be captured in a CUDA
    graph."""
    from .common import kv_len
    from .llama import cache_mask, causal_mask
    cfg = rank_config(cfg, params)
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, device=dev)[None, :].repeat(B, 1)
    x = embed(cfg, params, input_ids, positions, dtype)
    cos, sin = rope_tables(cfg, positions)
    if attn_mask is None:
        attn_mask = (causal_mask(S, S, dev) if kv_caches is None
                     else cache_mask(positions, kv_len(kv_caches[0][0])))
    new_caches = [] if kv_caches is not None else None
    for i, blk in enumerate(params["layers"]):
        cache_i = kv_caches[i] if kv_caches is not None else None
        x, nc = block_apply(cfg, blk, x, cos, sin, cache_i, cache_position,
                            attn_mask, linear_kw or {},
                            attn_window=attn_window)
        if new_caches is not None:
            new_caches.append(nc)
    x = final_hidden(cfg, params, x)
    return head_logits(cfg, params, x, linear_kw), new_caches
