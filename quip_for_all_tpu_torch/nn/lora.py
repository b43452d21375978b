"""LoRA adapters over quantized (or dense) linears — counterpart of
``quip_for_all_tpu/nn/lora.py``.

A wrapped linear is a ``LoraLinear`` module: the frozen base
(``QuantLinear`` or ``DenseLinear``) as ``lora_base``, ``lora_A`` (r, in)
and ``lora_B`` (out, r) as ``nn.Parameter``s and ``lora_scale`` = alpha/r,
dispatched by ``models/llama.py`` ``linear_apply``. Gradients reach A and B
only: ``add_lora`` freezes everything else, and the base's eval forward
passes them on to x (on the fused route through K3, the backward kernel of
``ops/fused_matmul.py``).

Trainable tensors are keyed by the JAX package's names
(``layers.3.self_attn.q_proj.lora_A``), so adapter files and
``np.random.default_rng(seed)`` draws of A agree between the packages.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from .qlinear import QuantLinear

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                   "gate_proj", "up_proj", "down_proj")


class LoraLinear(nn.Module):
    """A frozen base linear plus the rank-r update scale * x A^T B^T."""

    def __init__(self, lora_base: nn.Module, lora_A: torch.Tensor,
                 lora_B: torch.Tensor, lora_scale):
        super().__init__()
        self.lora_base = lora_base
        self.lora_A = nn.Parameter(lora_A)
        self.lora_B = nn.Parameter(lora_B)
        self.register_buffer("lora_scale", torch.as_tensor(
            lora_scale, dtype=torch.float32, device=lora_A.device))


def is_lora(node) -> bool:
    return isinstance(node, LoraLinear)


def _is_linear(node) -> bool:
    """QuantLinear, or a dense linear (an (out, in) ``weight``)."""
    w = getattr(node, "weight", None)
    return isinstance(node, QuantLinear) or (
        isinstance(w, torch.Tensor) and w.dim() == 2)


def _dims(lin) -> tuple:
    if isinstance(lin, QuantLinear):
        return lin.in_features, lin.out_features
    return lin.weight.shape[1], lin.weight.shape[0]


def _children(node):
    if isinstance(node, nn.ModuleDict):
        return list(node.items())
    if isinstance(node, nn.ModuleList):
        return [(str(i), v) for i, v in enumerate(node)]
    return []


def add_lora(model: nn.Module, rank: int = 8, alpha: float = 16.0,
             targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0,
             dtype=torch.float32) -> nn.Module:
    """Wrap the matching linears of ``model.layers`` in LoRA adapters, in
    place (A ~ N(0, 1/r), B = 0), and freeze everything but the adapters
    (those already there stay as they are and train too). A is drawn
    from ``np.random.default_rng(seed)`` walking the layers in the JAX
    tree's order (each block's modules in their insertion order, which
    ``LlamaModel.from_tree`` keeps), so one seed gives the JAX package's A.
    Returns ``model``."""
    rng = np.random.default_rng(seed)
    model.requires_grad_(False)

    def wrap(parent, name):
        for key, node in _children(parent):
            full = f"{name}.{key}"
            if is_lora(node):
                continue
            if _is_linear(node):
                if not any(full.endswith(t) for t in targets):
                    continue
                in_f, out_f = _dims(node)
                A = (rng.standard_normal((rank, in_f)) / np.sqrt(rank)
                     ).astype(np.float32)
                dev = (node.qweight.planes["w0"].device
                       if isinstance(node, QuantLinear) else node.weight.device)
                parent[key] = LoraLinear(
                    node, torch.from_numpy(A).to(device=dev, dtype=dtype),
                    torch.zeros((out_f, rank), dtype=dtype, device=dev),
                    alpha / rank)
            else:
                wrap(node, full)

    wrap(model.layers, "layers")
    for p in collect_lora_trainable(model.layers).values():
        p.requires_grad_(True)
    return model


def lora_apply(d: LoraLinear, x: torch.Tensor, **kw) -> torch.Tensor:
    """base(x) + scale * (x A^T) B^T, A and B cast to x's dtype."""
    from ..models.llama import linear_apply
    base = linear_apply(d.lora_base, x, **kw)
    h = x @ d.lora_A.to(x.dtype).T
    delta = h @ d.lora_B.to(x.dtype).T
    return base + d.lora_scale.to(x.dtype) * delta


def collect_lora_trainable(tree: nn.Module, prefix: str = ""
                           ) -> Dict[str, nn.Parameter]:
    """{name: parameter} of every adapter under ``tree`` (call with
    ``model.layers, "layers"`` for the JAX package's keys); the values are
    the live parameters."""
    out: Dict[str, nn.Parameter] = {}

    def walk(node, name):
        if is_lora(node):
            out[f"{name}.lora_A"] = node.lora_A
            out[f"{name}.lora_B"] = node.lora_B
            return
        for key, child in _children(node):
            walk(child, f"{name}.{key}" if name else key)

    walk(tree, prefix)
    return out


def apply_lora_trainable(tree: nn.Module, flat: Dict[str, object],
                         prefix: str = "") -> nn.Module:
    """Copy the arrays of ``flat`` (tensors or numpy, by the keys of
    ``collect_lora_trainable``) into the adapters under ``tree``, in place;
    adapters missing from ``flat`` keep their values. Returns ``tree``."""
    with torch.no_grad():
        for key, p in collect_lora_trainable(tree, prefix).items():
            if key in flat:
                v = flat[key]
                p.copy_(v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.asarray(v)))
    return tree
