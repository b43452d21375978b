"""Finetuning of quantized models: block-wise MSE and end-to-end CE —
counterpart of ``quip_for_all_tpu/quantize/finetune.py``.

Trainable leaves are addressed as a flat {path: tensor} dict: SU, SV and
bias of every ``QuantLinear`` and the weights (and biases) of the dense
linears and norms; codes and Hadamard factors stay frozen. The leaves are
installed into the modules as their buffers (``apply_trainable``), so the
forward's gradients reach them; ``torch.optim.Adam`` with two parameter
groups (SU/SV at ``ft_susv_lr``, the rest at ``ft_lr``) takes the place of
optax's ``multi_transform``. The training forward multiplies by each
quantized layer's dense ``calc_weight`` (cached as ``W_cache`` in the
block finetune), as in the JAX package: no decode kernel runs here.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.llama import DenseLinear, Weight
from ..models.tree import Norm
from ..nn.qlinear import QuantLinear, calc_weight

logger = logging.getLogger(__name__)

FlatParams = Dict[str, torch.Tensor]


def _walk(tree: Any, prefix: str, visit: Callable) -> None:
    def walk(node, name):
        if isinstance(node, (QuantLinear, DenseLinear, Weight, Norm)):
            visit(node, name)
            return
        if isinstance(node, (nn.ModuleDict, dict)):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
        elif isinstance(node, (nn.ModuleList, list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
    walk(tree, prefix)


def _fields(node, train_dense: bool):
    if isinstance(node, QuantLinear):
        return ("SU", "SV", "bias")
    return ("weight", "bias") if train_dense else ()


def collect_trainable(tree: Any, prefix: str = "",
                      train_dense: bool = True) -> FlatParams:
    """Trainable leaves as fresh leaf tensors that require grad (copies:
    a vector shared by several layers becomes one leaf each, as each
    reference QuantLinear owns its SU/SV)."""
    out: FlatParams = {}

    def visit(node, name):
        for f in _fields(node, train_dense):
            v = getattr(node, f, None)
            if v is not None:
                out[f"{name}.{f}"] = v.detach().clone().requires_grad_(True)
    _walk(tree, prefix, visit)
    return out


def apply_trainable(tree: Any, flat: FlatParams, prefix: str = "") -> Any:
    """Install flat[path] as the buffers at those paths (in place);
    returns ``tree``."""
    def visit(node, name):
        for f in ("SU", "SV", "bias", "weight"):
            key = f"{name}.{f}"
            if key in flat:
                setattr(node, f, flat[key])
    _walk(tree, prefix, visit)
    return tree


def freeze(flat: FlatParams) -> FlatParams:
    """Detached copies of the leaves (a snapshot, or the values to install
    once training is over)."""
    return {k: v.detach().clone() for k, v in flat.items()}


def make_susv_optimizer(ft_susv_lr: float, ft_lr: float,
                        flat: FlatParams) -> torch.optim.Adam:
    """Two-LR Adam over the leaves: SU/SV at ``ft_susv_lr``, the rest at
    ``ft_lr`` (optax's adam defaults: betas 0.9/0.999, eps 1e-8)."""
    susv = [v for k, v in flat.items() if k.endswith((".SU", ".SV"))]
    other = [v for k, v in flat.items() if not k.endswith((".SU", ".SV"))]
    groups = [g for g in ({"params": susv, "lr": ft_susv_lr},
                          {"params": other, "lr": ft_lr}) if g["params"]]
    return torch.optim.Adam(groups)


def _set_cache(blk, on: bool) -> None:
    for mod in blk.modules():
        if isinstance(mod, QuantLinear):
            mod.W_cache = (calc_weight(mod, dtype=torch.float32).detach()
                           if on else None)


def _mean_loss(losses: List[float]) -> float:
    return float(np.mean(np.asarray(losses, np.float32)))


def finetune_block(cfg, blk, batches_in: List[torch.Tensor],
                   batches_out: List[torch.Tensor], cos, sin, mask,
                   *, ft_susv_lr: float, ft_lr: float, epochs: int,
                   valid_frac: int, early_stop: int,
                   stats: Optional[list] = None) -> Any:
    """Block-wise MSE finetune against the float block's outputs
    (``batches_out``; inputs and targets may sit on the host, each is
    moved to the block's device as f32). Tunes ``blk`` in place with the
    best validation loss's leaves and returns it; ``stats``, when given,
    gets {"initial", "best"} validation losses appended."""
    from ..models.registry import get_arch, model_device
    ARCH = get_arch(cfg)
    dev = model_device(blk)
    with torch.no_grad():
        _set_cache(blk, True)
    flat = collect_trainable(blk)
    if not flat:
        _set_cache(blk, False)
        return blk
    apply_trainable(blk, flat)
    opt = make_susv_optimizer(ft_susv_lr, ft_lr, flat)

    n_valid = (max(1, len(batches_in) // max(valid_frac, 1))
               if valid_frac else 0)
    cut = len(batches_in) - n_valid
    train = list(zip(batches_in[:cut], batches_out[:cut]))
    valid = list(zip(batches_in[cut:], batches_out[cut:]))

    def f32(a):
        return a.to(device=dev, dtype=torch.float32)

    def loss_fn(x, target):
        y = ARCH.block_apply(cfg, blk, f32(x), cos, sin, attn_mask=mask,
                             linear_kw={"training": True})[0]
        return torch.mean((y - f32(target)) ** 2)

    def valid_loss():
        if not valid:
            return float("inf")
        with torch.no_grad():
            return _mean_loss([float(loss_fn(a, b)) for a, b in valid])

    best = initial = valid_loss()
    best_flat = freeze(flat)
    worse = 0
    for _ in range(epochs):
        for a, b in train:
            opt.zero_grad(set_to_none=True)
            loss_fn(a, b).backward()
            opt.step()
        cur = valid_loss()
        if cur < best:
            best, best_flat, worse = cur, freeze(flat), 0
        else:
            worse += 1
            if worse >= early_stop:
                break
    if stats is not None:
        stats.append({"initial": initial, "best": best})
    apply_trainable(blk, best_flat)
    _set_cache(blk, False)
    return blk


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against soft targets (B, S, V) or token ids (B, S)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    if targets.dim() == logits.dim():
        return -(targets * logp).sum(-1).mean()
    oh = F.one_hot(targets.long(), logits.shape[-1]).to(torch.float32)
    return -(oh * logp).sum(-1).mean()


def make_train_step(cfg, optimizer: torch.optim.Optimizer, model,
                    flat: FlatParams) -> Callable:
    """End-to-end CE training step over the leaves ``flat`` (installed
    into ``model`` here). Returns step(ids (B, S), targets (B, S, V)
    softmax or (B, S) ids) -> loss, one Adam update each call."""
    from ..models.registry import get_arch
    ARCH = get_arch(cfg)
    apply_trainable(model.layers if hasattr(model, "layers") else
                    model["layers"], flat)

    def step(ids, targets):
        optimizer.zero_grad(set_to_none=True)
        logits, _ = ARCH.model_apply(cfg, model, ids,
                                     linear_kw={"training": True})
        loss = ce_loss(logits, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step
