"""Carry a JAX param tree across into the port's modules, without importing
JAX: attributes are read by name and arrays through ``np.asarray``.

The tree is the JAX package's unfused param dict of any family (nested
dicts and lists — Mixtral's ``block_sparse_moe`` holds a dense ``gate``
dict and an ``experts`` list of {w1, w2, w3}; ``QuantLinearParams`` /
``QuantizedTensor`` leaves recognised by their fields): llama, Mixtral and
Baichuan become a ``LlamaModel``, the other families (GPT-2, GPT-NeoX,
OPT, Falcon, Phi, GPT-J, QWen) a ``FamilyModel`` (``models/tree.py``),
chosen by the config. Planes cross in
their runtime layout as they are (any of ``ops/qtensor.py``'s layouts:
pb's and bfp's 3-D planes and sw's int16/int8 subwords included), with the
tensor's ``opt_resid_scale``. LoRA nodes ({"lora_base", "lora_A",
"lora_B", "lora_scale"}, ``nn/lora.py`` there) cross as ``LoraLinear``s.
Fuse afterwards with the port's own ``fuse_for_inference``, which stacks
the experts and leaves LoRA-wrapped linears unfused.
bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy, which
``torch.from_numpy`` refuses: they go through float32 (exact) and back to
bfloat16.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import LLAMA_ARCHS, LlamaModel
from ..models.tree import FamilyModel
from ..nn.qlinear import QuantLinear
from ..ops.qtensor import QuantizedTensor
from .device import resolve_device


def to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _qtensor(q, device) -> QuantizedTensor:
    return QuantizedTensor(
        {k: to_torch(v, device) for k, v in q.planes.items()},
        q.codebook_id, int(q.q_out), int(q.q_in),
        float(q.opt_resid_scale), layout=q.layout)


def qlinear_from_jax(p, device="cuda") -> QuantLinear:
    """One ``QuantLinearParams`` -> ``QuantLinear`` on ``device``, its
    block-diagonal shard counts (``shards_left`` / ``shards_right``)
    included."""
    device = resolve_device(device)

    def opt(a):
        return None if a is None else to_torch(a, device)
    return QuantLinear(
        _qtensor(p.qweight, device), in_features=int(p.in_features),
        out_features=int(p.out_features), q_in=int(p.q_in),
        q_out=int(p.q_out), K_left=int(p.K_left), K_right=int(p.K_right),
        SU=opt(p.SU), SV=opt(p.SV), bias=opt(p.bias),
        had_left=opt(p.had_left), had_right=opt(p.had_right),
        Wscale=opt(p.Wscale), per_channel=bool(p.per_channel),
        wscale_float=float(np.asarray(p.wscale_float)),
        shards_left=int(getattr(p, "shards_left", 1)),
        shards_right=int(getattr(p, "shards_right", 1)))


def _walk(node, device, memo):
    if node is None:
        return None
    if hasattr(node, "qweight") and hasattr(node, "wscale_float"):
        return qlinear_from_jax(node, device)
    if isinstance(node, dict):
        return {k: _walk(v, device, memo) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, device, memo) for v in node]
    # arrays shared by object in the JAX tree (the random model's shared
    # SU or hadK) stay shared in the port, which fuse_for_inference relies on
    if id(node) not in memo:
        memo[id(node)] = (node, to_torch(node, device))
    return memo[id(node)][1]


def from_jax_params(tree: Any, device="cuda",
                    cfg: Optional[ModelConfig] = None):
    """JAX param tree -> the port's model on ``device``: a ``LlamaModel``
    for a llama, Mixtral or Baichuan ``cfg`` (and without one), else the
    family's ``FamilyModel``."""
    dev = resolve_device(device)
    port = _walk(tree, dev, {})
    if cfg is None or cfg.arch in LLAMA_ARCHS:
        return LlamaModel.from_tree(port)
    return FamilyModel.from_tree(cfg, port)
