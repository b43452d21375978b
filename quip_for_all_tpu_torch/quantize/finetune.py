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

Under a ("dp", ["ep",] "tp") mesh (``parallel/sharding.py``
``shard_params``) the same functions take a rank's model: each leaf of the
JAX package's ``collect_trainable`` maps to one tensor a rank, whole or its
tp shard (the parallel layers' ``slots``; a rank's stacked experts have
none, as stacked experts have none in the JAX package), whose gradients
the sharded forward gives as the whole model's (``parallel/layers.py``:
the tp cuts, and the expert axis's ``ExpertParallelMoE``);
``make_train_step(..., mesh=)`` trains each rank on its dp part of the
batch and averages the loss and the gradients over "dp", so that every
rank takes the one-rank step; ``gather_trainable`` puts a rank's leaves
(or their gradients) back into the JAX package's names and shapes.
"""
from __future__ import annotations

import contextlib
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


def _slots(tree: Any, prefix: str, train_dense: bool) -> list:
    """(key, module, field, tp-cut axis or None, the parallel layer's
    mesh or None) of every trainable leaf:
    SU/SV/bias of a ``QuantLinear``, weight/bias of the dense linears,
    norms and tables (with ``train_dense``), under the JAX package's key;
    a rank's parallel layer names where its leaves live (``slots``).
    Fused groups and stacked experts have none, as in the JAX package."""
    from ..nn.qlinear import FusedQuantLinear
    from ..nn.qmoe import StackedQuantLinear
    from ..parallel.layers import _Parallel
    out = []

    def walk(node, name):
        if isinstance(node, _Parallel):
            slots = node.slots(train_dense)
            if slots is None:               # not cut: the whole layer
                return walk(node.local, name)
            out.extend((f"{name}.{f}", m, f, d, node.mesh)
                       for f, (m, d) in slots.items())
            return
        if isinstance(node, QuantLinear):
            fields = ("SU", "SV", "bias")
        elif isinstance(node, (DenseLinear, Weight, Norm)):
            fields = ("weight", "bias") if train_dense else ()
        elif isinstance(node, (FusedQuantLinear, StackedQuantLinear)):
            return
        elif isinstance(node, (nn.ModuleList, list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
            return
        else:
            kids = node.items() if isinstance(node, dict) \
                else node.named_children()
            for k, v in kids:
                walk(v, f"{name}.{k}" if name else k)
            return
        out.extend((f"{name}.{f}", node, f, None, None) for f in fields
                   if getattr(node, f, None) is not None)
    walk(tree, prefix)
    return out


def collect_trainable(tree: Any, prefix: str = "",
                      train_dense: bool = True) -> FlatParams:
    """Trainable leaves as fresh leaf tensors that require grad (copies:
    a vector shared by several layers becomes one leaf each, as each
    reference QuantLinear owns its SU/SV). On a rank's model a leaf cut
    over tp is the rank's shard (``gather_trainable`` joins them)."""
    return {k: getattr(m, f).detach().clone().requires_grad_(True)
            for k, m, f, _, _ in _slots(tree, prefix, train_dense)}


def apply_trainable(tree: Any, flat: FlatParams, prefix: str = "") -> Any:
    """Install flat[path] as the buffers at those paths (in place);
    returns ``tree``."""
    for k, m, f, _, _ in _slots(tree, prefix, True):
        if k in flat:
            setattr(m, f, flat[k])
    return tree


def gather_trainable(tree: Any, flat: FlatParams, prefix: str = "",
                     grads: bool = False) -> FlatParams:
    """The JAX package's flat leaves (names and whole shapes) from a
    rank's ``collect_trainable`` (its values, or with ``grads`` their
    ``.grad``, None where a leaf got none): a leaf cut over tp is gathered
    from the ranks of the tree's tp group (every rank calls this; one
    ``all_gather`` a cut leaf), a whole one copied. On a model of one
    rank it copies every leaf."""
    from ..parallel import comm
    out = {}
    for k, _, _, dim, mesh in _slots(tree, prefix, True):
        if k not in flat:
            continue
        v = flat[k].grad if grads else flat[k]
        if v is None:
            out[k] = None
            continue
        v = v.detach()
        if dim is not None:
            whole = comm.all_gather(v.movedim(dim, -1), mesh.tp_group,
                                    mesh.tp)
            v = whole.movedim(-1, dim)
        out[k] = v.clone()
    return out


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


@contextlib.contextmanager
def dense_weights(modules):
    """Inside the ``with``, every ``QuantLinear`` of ``modules`` keeps
    ``calc_weight``'s f32 W as its ``W_cache``, which the f32 training
    forward multiplies by: the value it would compute at every call,
    computed once (the codes do not train). A step's graph then holds one
    W a linear, not one per call (a pipeline stage calls each linear once
    a microbatch)."""
    with torch.no_grad():
        for m in modules:
            _set_cache(m, True)
    try:
        yield
    finally:
        for m in modules:
            _set_cache(m, False)


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


def student_logits(cfg, model, ids: torch.Tensor, pp_mesh=None,
                   n_microbatches: int = 1) -> torch.Tensor:
    """The end-to-end finetune's student forward: (B, S) ids -> (B, S, V)
    logits through the training forward of the linears, the whole model
    on this rank or, with ``pp_mesh``, pipelined over its ranks in
    ``n_microbatches`` microbatches (``parallel/pipeline.py``; the same
    logits on every rank)."""
    kw = {"training": True}
    if pp_mesh is None:
        from ..models.registry import get_arch
        return get_arch(cfg).model_apply(cfg, model, ids, linear_kw=kw)[0]
    from ..parallel.pipeline import pipeline_logits
    return pipeline_logits(cfg, model, ids, pp_mesh, n_microbatches,
                           linear_kw=kw)


def student_modules(cfg, model, pp_mesh=None) -> list:
    """The modules whose linears ``student_logits`` runs on this rank:
    its stage's blocks (every block without ``pp_mesh``) and the untied
    head, for ``dense_weights``."""
    from ..models import registry as R
    if pp_mesh is None:
        blocks = list(R.model_layers(model))
    else:
        from ..parallel.pipeline import stage_blocks
        blocks = stage_blocks(model, pp_mesh)
    key = R.untied_head_key(cfg, model)
    return blocks + ([dict(model.named_children())[key]] if key else [])


def dp_part(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's part of a global batch (B, ...) along B, by its dp
    index (B divisible by dp)."""
    if t.shape[0] % mesh.dp:
        raise ValueError(f"batch {t.shape[0]} does not split over dp="
                         f"{mesh.dp}")
    n = t.shape[0] // mesh.dp
    return t[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def make_train_step(optimizer: torch.optim.Optimizer,
                    logits_fn: Callable, mesh=None) -> Callable:
    """End-to-end CE training step. Returns step(ids (B, S), targets (B,
    S, V) softmax or (B, S) ids) -> loss: ``logits_fn(ids)``, the loss's
    gradients, one ``optimizer`` update. With a ("dp", ["ep",] "tp")
    ``mesh`` (the one ``logits_fn``'s sharded model runs on; every rank
    calls the step with the whole batch) each rank takes its dp part of
    ids and targets, and the loss (the mean over the whole batch) and
    every gradient are averaged over the dp group before the update, so
    every rank takes the same step. The tp and ep ranks of one dp index
    need nothing more: the sharded forward gives each of them the whole
    gradients."""

    def step(ids, targets):
        if mesh is not None:
            ids, targets = dp_part(ids, mesh), dp_part(targets, mesh)
        optimizer.zero_grad(set_to_none=True)
        loss = ce_loss(logits_fn(ids), targets)
        loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.dp > 1:
            _dp_mean([loss] + [p.grad for g in optimizer.param_groups
                               for p in g["params"] if p.grad is not None],
                     mesh)
        optimizer.step()
        return loss
    return step


def _dp_mean(ts: List[torch.Tensor], mesh) -> None:
    """Each tensor averaged over the dp group, in place (one all_reduce
    a tensor, counted in ``parallel/comm.py``)."""
    from ..parallel import comm
    for t in ts:
        comm.all_reduce(t, mesh.dp_group)
        t.div_(mesh.dp)
