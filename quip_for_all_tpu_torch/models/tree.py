"""The param tree of the families other than llama, Mixtral and Baichuan
(GPT-2, GPT-NeoX, OPT, Falcon, Phi, GPT-J, QWen).

A family module's ``param_skeleton(cfg)`` mirrors the JAX package's
``init_*_params``: the same nested dict and list structure, with each leaf
a spec of what sits there (``LinearSpec``, ``NormSpec``, ``TableSpec``)
instead of an array. ``random_quantized_model``, the checkpoint loader and
``FamilyModel.from_tree`` walk it. A ``FamilyModel`` is that tree as
``nn.ModuleDict`` / ``nn.ModuleList`` nodes, indexed by the JAX keys
(``model["layers"][i]["attn"]["c_attn"]``), with linear leaves
``QuantLinear``, ``FusedQuantLinear`` (QWen's fused w1/w2),
``DenseLinear`` or ``LoraLinear``, norms ``Norm`` and embedding tables
``Weight``. ``init_params`` walks it to make the dense float model of the
JAX package's ``init_<family>_params``, draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.lora import LoraLinear
from .config import ModelConfig
from .llama import DenseLinear, Weight


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """A linear layer: (out_f, in_f) weight, a bias or not."""
    out_f: int
    in_f: int
    bias: bool


@dataclasses.dataclass(frozen=True)
class NormSpec:
    """A LayerNorm (scale and bias) or an RMSNorm (scale only) of width n."""
    n: int
    bias: bool


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """An embedding table (rows, cols)."""
    rows: int
    cols: int


class Norm(nn.Module):
    """A norm's scale and optional bias."""

    def __init__(self, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)


def map_skeleton(skel: Any, fn: Callable[[Tuple, Any], Any],
                 path: Tuple = ()) -> Any:
    """The skeleton's structure with each leaf spec replaced by
    ``fn(path, spec)`` (path: the keys and list indices from the root)."""
    if isinstance(skel, dict):
        return {k: map_skeleton(v, fn, path + (k,)) for k, v in skel.items()}
    if isinstance(skel, list):
        return [map_skeleton(v, fn, path + (i,)) for i, v in enumerate(skel)]
    return fn(path, skel)


def get_path(node: Any, path: str) -> Any:
    """``node`` at a dotted path of keys and list indices."""
    for part in path.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def set_path(node: Any, path: str, value: Any) -> None:
    parts = path.split(".")
    parent = get_path(node, ".".join(parts[:-1])) if len(parts) > 1 else node
    last = parts[-1]
    parent[int(last) if last.isdigit() else last] = value


class FamilyModel(nn.ModuleDict):
    """The model's weights, keyed as the JAX param tree;
    ``models/registry.py`` ``get_arch(cfg).model_apply(cfg, model, ids,
    ...)`` runs it."""

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: Dict[str, Any]
                  ) -> "FamilyModel":
        """Build from a JAX-shaped dict tree whose leaves are tensors or
        already-built modules; each leaf's kind comes from the family's
        skeleton at the same path. A {"lora_base", ...} node becomes a
        ``LoraLinear``; keys whose value is None are left out."""
        from .registry import get_arch
        skel = get_arch(cfg).param_skeleton(cfg)

        def build(node, spec):
            if isinstance(node, nn.Module):
                return node
            if isinstance(spec, LinearSpec):
                if "lora_base" in node:
                    return LoraLinear(build(node["lora_base"], spec),
                                      node["lora_A"], node["lora_B"],
                                      node["lora_scale"])
                return DenseLinear(node["weight"], node.get("bias"))
            if isinstance(spec, NormSpec):
                return Norm(node["weight"], node.get("bias"))
            if isinstance(spec, TableSpec):
                return Weight(node["weight"])
            if isinstance(node, list):
                return nn.ModuleList([build(n, s)
                                      for n, s in zip(node, spec)])
            return nn.ModuleDict({k: build(v, spec[k])
                                  for k, v in node.items() if v is not None})
        return cls(build(tree, skel))


# the tables the JAX inits draw at 0.01 (learned positions) instead of 0.02,
# and the linears they draw as a 0.02 table (GPT-NeoX's untied head)
_TABLE_SCALE = {"wpe": 0.01, "embed_positions": 0.01}
_LINEAR_AS_TABLE = ("embed_out",)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> "FamilyModel":
    """The dense float model of the family's JAX ``init_<family>_params``
    on ``device`` (the card unless the caller asks for the CPU): the
    skeleton's leaves in its order, each linear a (out, in) normal draw
    over sqrt(in) with a zero bias where it has one, each table a normal
    draw times 0.02 (0.01 for learned positions), norms ones (and zero
    biases), from one numpy ``default_rng(seed)``; the skeletons keep the
    JAX inits' order, so the weights are theirs bit for bit."""
    from ..utils.device import resolve_device
    from .registry import get_arch
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    def leaf(path, spec):
        if isinstance(spec, LinearSpec):
            shape = (spec.out_f, spec.in_f)
            if path[-1] in _LINEAR_AS_TABLE:
                w = rng.standard_normal(shape) * 0.02
            else:
                w = rng.standard_normal(shape) / np.sqrt(spec.in_f)
            return {"weight": t(w.astype(np.float32)),
                    "bias": t(np.zeros(spec.out_f, np.float32))
                    if spec.bias else None}
        if isinstance(spec, NormSpec):
            return {"weight": t(np.ones(spec.n, np.float32)),
                    "bias": t(np.zeros(spec.n, np.float32))
                    if spec.bias else None}
        w = rng.standard_normal((spec.rows, spec.cols)) * _TABLE_SCALE.get(
            path[-1], 0.02)
        return {"weight": t(w.astype(np.float32))}
    skel = get_arch(cfg).param_skeleton(cfg)
    return FamilyModel.from_tree(cfg, map_skeleton(skel, leaf))
