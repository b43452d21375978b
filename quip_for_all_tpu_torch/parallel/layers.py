"""A rank's linears under tensor parallelism: megatron's column- and
row-parallel layers over quantized (``QuantLinear``, ``FusedQuantLinear``)
and dense (``DenseLinear``) weights, with the collectives of
``parallel/comm.py``. ``parallel/sharding.py`` ``shard_params`` builds
them; the models call them through ``models/llama.py`` ``linear_apply``
(or as a fused group's module), like the layers they wrap.

The JAX package shards with GSPMD and lets XLA place the collectives; here
they are explicit, and compute the same function:

- a column-parallel layer keeps rows [r·q_out/tp, (r+1)·q_out/tp) of its
  planes (each segment's rows, for a fused group). Where its right
  transform is block-diagonal over a multiple of tp blocks
  (``shards_right``) the rank applies its own blocks and gets its rows of
  the output with no collective; else
  the rank's rows of the product are all-gathered before the whole right
  transform, as GSPMD gathers them;
- a row-parallel layer keeps the plane columns of its input slice (each
  rank's groups padded to 128 columns again, with zero x lanes in the
  pad). Where its left transform is block-diagonal over a multiple of tp
  blocks (``shards_left``) the rank transforms its own input slice; else
  the whole input is transformed and then sliced. The f32 partial
  products are summed over the ranks (``all_reduce``) before the
  per-channel scale and the right transform, which every rank applies
  whole.

A rank's Mixtral block with its experts cut over "ep"
(``ExpertParallelMoE``) runs its own experts on every token and sums the
f32 result over its ep group (one ``all_reduce``) before the cast: in one
expert-indexed launch a stacked linear without gradients, or, in a
forward that autograd differentiates, through the per-expert dense loop
over its own experts, whose router logits and input pass through
``comm.enter`` over the ep group so that every rank gets the whole
gradient.

A layer's ``view`` says what the model reads from a column-parallel
output: ``"chunk"`` (the rank's contiguous rows: its heads, or its slice
of an MLP's hidden width), ``"full"`` (the whole output: attention whose
heads do not split over the ranks, the head's logits), or a tuple of
segment widths (``[q|k|v]`` laid out contiguously, as GPT-2's ``c_attn``
or Baichuan's ``W_pack``: the rank reads its slice of each segment). A
row-parallel layer's ``in_local`` says whether its input arrives as the
rank's slice or whole. A layer that does not split (``cut`` false) keeps
the whole weight and runs on the whole input, as GSPMD replicates it.

The training forward (``linear_kw["training"]``: the JAX package's dense
W, gradients to SU, SV, bias and x) runs on the shards as GSPMD runs it:
where a side's transform is the rank's own, the rank decodes its rows
(column shard) or columns (row shard) of W (``calc_weight`` of its
planes) and multiplies by them; on the routes with a whole transform it
keeps the eval route's order, with the dense decode of its planes in
place of the kernel. The eval route is differentiable in x too (through
K2/K3 on the fused route), which a LoRA step through a sharded base
takes. Gradients are those of the whole model: a replicated value of
which the rank uses its part alone (x after SU before a column shard's
rows, the whole input before a row shard's slice, a column output a view
takes a part of, an adapter's A or B where its product is cut) passes
through ``comm.enter``, whose backward sums the gradient over the tp
group once; one used whole on every rank (norms, the embedding, SV and
bias after a gather or a sum) is not summed. ``slots`` names where each
trainable leaf of the JAX package's ``collect_trainable`` lives on the
rank, whole or as its tp shard (``quantize/finetune.py``).

A LoRA adapter added after ``shard_params`` wraps the parallel layer
(``nn/lora.py``); ``lora`` computes the rank's view of base + scale ·
(x Aᵀ) Bᵀ with A and B whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..nn.qlinear import (FusedQuantLinear, QuantLinear, _epilogue,
                          apply_after_su, calc_weight, fused_left,
                          fused_right, left_product, right_side)
from ..ops.dequant import decode_weights
from ..ops.quant_matmul import FUSED_MAX_M, quant_matmul
from ..transforms.incoherence import matmul_hadUt
from . import comm

View = Union[str, tuple]
# field -> (module holding it, tp-cut axis of the leaf or None: whole)
Slots = Dict[str, Tuple[nn.Module, Optional[int]]]


def _dense(lin, x: torch.Tensor) -> torch.Tensor:
    """``linear_apply``'s dense product without the bias: products of
    x-dtype values summed in f32, as f32."""
    w = lin.weight.to(x.dtype).to(torch.float32)
    return torch.matmul(x.to(torch.float32), w.T)


def _quant_kw(kw: dict) -> dict:
    if kw.get("dense_weight") is not None:
        raise NotImplementedError(
            "a dense_weight under a mesh (the block finetune's cache; it "
            "runs unsharded: ROADMAP.md queue 1 item 8d)")
    return dict(compute_dtype=kw.get("compute_dtype", torch.bfloat16),
                matmul_impl=kw.get("matmul_impl", "auto"),
                max_m=kw.get("max_m", FUSED_MAX_M))


def _rows_product(lin: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """The training forward's product on a route with a whole transform:
    x (after SU) through the left transform, times the dense decode of
    the rank's planes (in place of the kernel), and the rank's
    per-channel scale."""
    xt = matmul_hadUt(x, lin.left_spec, scale=lin.wscale_float)
    out = xt @ decode_weights(lin.qweight, dtype=x.dtype).T
    if lin.per_channel:
        out = out * lin.Wscale.to(x.dtype)
    return out


def _dims(lin: nn.Module) -> Tuple[int, int]:
    """(in, out) features of a whole linear of any kind."""
    from ..nn.lora import LoraLinear
    if isinstance(lin, LoraLinear):
        return lin.lora_A.shape[1], lin.lora_B.shape[0]
    if isinstance(lin, (QuantLinear, FusedQuantLinear)):
        out = (lin.out_features if isinstance(lin, QuantLinear)
               else sum(p.out_features for p in lin.segments))
        return lin.in_features, out
    return lin.weight.shape[1], lin.weight.shape[0]


class _Parallel(nn.Module):
    def __init__(self, local: nn.Module, mesh, dims: Tuple[int, int]):
        super().__init__()
        self.local = local
        self.mesh = mesh
        self.tp, self.rank = mesh.tp, mesh.tp_rank
        # the whole layer's (in, out) features
        self.in_features, self.out_features = dims

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(t, self.mesh.tp_group, self.tp)

    def _enter(self, t: torch.Tensor) -> torch.Tensor:
        return comm.enter(t, self.mesh.tp_group)

    def _own(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's slice of the last axis (of width n)."""
        w = n // self.tp
        return t[..., self.rank * w:(self.rank + 1) * w]

    def slots(self, train_dense: bool = True) -> Optional[Slots]:
        """Where the trainable leaves of the whole layer live on this rank
        (the JAX package's ``collect_trainable`` fields), or None where
        the layer is not cut (``local`` is the whole layer)."""
        if not self.cut:
            return None
        if isinstance(self.local, FusedQuantLinear):
            return {}
        if not isinstance(self.local, QuantLinear):
            return (self._dense_slots() if train_dense else {})
        return self._quant_slots()


def _present(slots: Slots) -> Slots:
    return {f: (m, d) for f, (m, d) in slots.items()
            if getattr(m, f, None) is not None}


class ColParallel(_Parallel):
    """A column-parallel linear (see the module docstring): ``local`` the
    rank's rows (or the whole layer when not ``cut``), ``full`` the whole
    layer's right side without planes, for the gathering route."""

    def __init__(self, local: nn.Module, mesh, *, cut: bool,
                 right_local: bool, view: View, dims: Tuple[int, int],
                 full: nn.Module = None, seg_out: Sequence[int] = ()):
        super().__init__(local, mesh, dims)
        self.cut, self.right_local, self.view = cut, right_local, view
        self.full = full
        # a fused group's segment widths (whole), for its gather
        self.seg_out = tuple(seg_out)

    def _select(self, y: torch.Tensor) -> torch.Tensor:
        """The model's view of a whole output (computed on every rank:
        where the view is a part, its gradient is summed over the ranks)."""
        if self.view == "full":
            return y
        y = self._enter(y)
        if self.view == "chunk":
            return self._own(y, y.shape[-1])
        outs, off = [], 0
        for n in self.view:
            outs.append(self._own(y[..., off:off + n], n))
            off += n
        return torch.cat(outs, dim=-1)

    def _from_rows(self, y: torch.Tensor) -> torch.Tensor:
        """The view from the rank's contiguous rows of the output."""
        if self.view == "chunk":
            return y
        return self._select(self._gather(y))

    def forward(self, x: torch.Tensor, **kw):
        lin = self.local
        qkw = _quant_kw(kw)
        if not self.cut:
            if isinstance(lin, FusedQuantLinear):
                return [self._select(y) for y in lin(x, **qkw)]
            from ..models.llama import linear_apply
            return self._select(linear_apply(lin, x, **kw))
        if isinstance(lin, FusedQuantLinear):
            return self._fused(x, qkw)
        if not isinstance(lin, QuantLinear):          # dense rows
            y = _dense(lin, self._enter(x)).to(x.dtype)
            if lin.bias is not None:
                y = y + lin.bias.to(y.dtype)
            return self._from_rows(y)
        batch = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if lin.SU is not None:
            x2 = x2 * lin.SU.to(x2.dtype)
        x2 = self._enter(x2)
        training = bool(kw.get("training"))
        if self.right_local:
            return self._from_rows(apply_after_su(lin, x2, batch,
                                                  training=training, **qkw))
        if training:
            out = _rows_product(lin, x2)
        else:
            out, _ = left_product(lin, x2, **qkw)
        out = self._gather(out.to(x2.dtype))
        return self._select(right_side(self.full, out, False, batch))

    def _fused(self, x: torch.Tensor, qkw: dict):
        """A cut fused group (the eval route, as the JAX package runs a
        fused group in a training forward too)."""
        lin = self.local
        batch = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if lin.SU is not None:
            x2 = x2 * lin.SU.to(x2.dtype)
        x2 = self._enter(x2)
        if self.right_local:
            big, right_done, pre = fused_left(
                lin, x2, right_in_kernel=lin.right_in_kernel, **qkw)
            outs = fused_right(lin, big.to(x2.dtype), right_done, pre,
                               batch)
            if self.view == "chunk":
                return outs
            return [self._gather(y) for y in outs]
        big, _, _ = fused_left(lin, x2, scaled=False, **qkw)
        big = self._gather(big.to(x2.dtype))        # rank-major segments
        per = [n // self.tp for n in self.seg_out]
        width = sum(per)
        segs, off = [], 0
        for n in per:
            segs.append(torch.cat(
                [big[:, r * width + off:r * width + off + n]
                 for r in range(self.tp)], dim=-1))
            off += n
        outs = fused_right(self.full, torch.cat(segs, dim=-1), False, False,
                           batch)
        if self.view == "chunk":
            return [self._own(self._enter(y), y.shape[-1]) for y in outs]
        return outs

    def _dense_slots(self) -> Slots:
        return _present({"weight": (self.local, 0), "bias": (self.local, 0)})

    def _quant_slots(self) -> Slots:
        lin = self.local
        if self.right_local:
            return _present({"SU": (lin, None), "SV": (lin, 0),
                             "bias": (lin, 0)})
        return _present({"SU": (lin, None), "SV": (self.full, None),
                         "bias": (self.full, None)})

    def lora(self, d, x: torch.Tensor, **kw) -> torch.Tensor:
        """The rank's view of base(x) + scale (x Aᵀ) Bᵀ (``d`` the
        ``LoraLinear`` wrapping this layer, A and B whole): for the
        "chunk" view the delta of B's rows of this rank (A's product
        entering the rank's part, B's gradient summed over the ranks),
        else the whole delta, then the view."""
        base = self(x, **kw)
        A, B = d.lora_A.to(x.dtype), d.lora_B.to(x.dtype)
        h = x @ A.T
        if self.view == "chunk":
            n = self.out_features // self.tp
            B = self._enter(B)[self.rank * n:(self.rank + 1) * n]
            delta = self._enter(h) @ B.T
        else:
            delta = self._select(h @ B.T)
        return base + d.lora_scale.to(x.dtype) * delta


class RowParallel(_Parallel):
    """A row-parallel linear (see the module docstring): ``local`` the
    rank's plane columns with the whole right side (or the whole layer
    when not ``cut``), ``full`` the whole layer's left side without
    planes, for the route that transforms the whole input."""

    def __init__(self, local: nn.Module, mesh, *, cut: bool,
                 left_local: bool, in_local: bool, dims: Tuple[int, int],
                 full: nn.Module = None):
        super().__init__(local, mesh, dims)
        self.cut, self.left_local, self.in_local = cut, left_local, in_local
        self.full = full

    def _whole_input(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x) if self.in_local else x

    def _own_input(self, x: torch.Tensor) -> torch.Tensor:
        return (x if self.in_local
                else self._own(self._enter(x), self.in_features))

    def _sum(self, part: torch.Tensor, dtype) -> torch.Tensor:
        """The ranks' f32 partial products summed, in ``dtype``."""
        return comm.all_reduce(part.to(torch.float32).contiguous(),
                               self.mesh.tp_group).to(dtype)

    def forward(self, x: torch.Tensor, **kw):
        lin = self.local
        qkw = _quant_kw(kw)
        if not self.cut:
            from ..models.llama import linear_apply
            return linear_apply(lin, self._whole_input(x), **kw)
        if not isinstance(lin, QuantLinear):          # dense columns
            y = self._sum(_dense(lin, self._own_input(x)), x.dtype)
            if lin.bias is not None:
                y = y + lin.bias.to(y.dtype)
            return y
        training = bool(kw.get("training"))
        batch, x_dtype = x.shape[:-1], x.dtype
        if self.left_local:
            xl = self._own_input(x).reshape(-1, lin.q_in)
            if lin.SU is not None:
                xl = xl * lin.SU.to(x_dtype)
            if training:
                # the rank's columns of W, both transforms and the scales
                # in them: the sum is x @ W
                W = lin.W_cache
                if W is None:
                    W = calc_weight(lin, dtype=x_dtype)
                out = self._sum(xl @ W.to(x_dtype), x_dtype)
                return _epilogue(lin, out[:, :lin.out_features], batch)
            part, _ = left_product(lin, xl, scaled=False, **qkw)
        else:
            full = self.full
            xf = self._whole_input(x).reshape(-1, full.in_features)
            if full.SU is not None:
                xf = xf * full.SU.to(x_dtype)
            xt = matmul_hadUt(xf, full.left_spec, scale=full.wscale_float)
            xl = self._own(self._enter(xt), full.q_in)
            if training:
                part = xl @ decode_weights(lin.qweight, dtype=x_dtype).T
            else:
                part = quant_matmul(xl.to(qkw["compute_dtype"]),
                                    lin.qweight, impl=qkw["matmul_impl"],
                                    max_m=qkw["max_m"], ksplit=lin.ksplit,
                                    combine=lin.combine)
        out = self._sum(part, x_dtype)
        if lin.per_channel:
            out = out * lin.Wscale.to(x_dtype)
        return right_side(lin, out, False, batch)

    def _dense_slots(self) -> Slots:
        return _present({"weight": (self.local, 1),
                         "bias": (self.local, None)})

    def _quant_slots(self) -> Slots:
        lin = self.local
        su = (lin, 0) if self.left_local else (self.full, None)
        return _present({"SU": su, "SV": (lin, None), "bias": (lin, None)})

    def lora(self, d, x: torch.Tensor, **kw) -> torch.Tensor:
        """base(x) + scale (x Aᵀ) Bᵀ, whole (``d`` the ``LoraLinear``
        wrapping this layer): where the input is the rank's slice, the
        rank's x_r A[:, cols_r]ᵀ summed over the ranks as an f32 (m, r)
        partial (A's gradient summed over the ranks), then Bᵀ whole."""
        base = self(x, **kw)
        A, B = d.lora_A.to(x.dtype), d.lora_B.to(x.dtype)
        if self.in_local:
            h = self._sum(x @ self._own(self._enter(A), self.in_features).T,
                          x.dtype)
        else:
            h = x @ A.T
        return base + d.lora_scale.to(x.dtype) * (h @ B.T)


class ExpertParallelMoE(nn.ModuleDict):
    """A rank's Mixtral MoE block over the "ep" axis: the router ``gate``
    (replicated) and ``experts_stacked`` (``w13``, ``w2``) holding experts
    [offset, offset + E/ep) of the model's E, whole (the tp ranks of one
    ep index hold the same experts). ``models/llama.py`` ``moe_apply``
    routes over all E experts and takes, without gradients, ``nn/qmoe.py``
    ``moe_dense_stacked_apply`` with ``combine`` as its ``reduce``; in a
    forward that autograd differentiates (``differentiated``), the JAX
    package's per-expert dense loop over the rank's own experts, reading
    the block's input and the router's logits through ``enter``, its
    partial summed by ``combine``."""

    def __init__(self, gate: nn.Module, w13: nn.Module, w2: nn.Module, *,
                 offset: int, mesh):
        super().__init__({"gate": gate, "experts_stacked": nn.ModuleDict(
            {"w13": w13, "w2": w2})})
        self.offset = offset
        self.mesh = mesh

    def combine(self, partial: torch.Tensor) -> torch.Tensor:
        """The f32 partial output of this rank's experts summed over its
        ep group, the other experts' ranks (its backward the identity)."""
        return comm.all_reduce(partial.contiguous(), self.mesh.ep_group)

    @staticmethod
    def differentiated(x: torch.Tensor, linear_kw: dict) -> bool:
        """Whether autograd differentiates this forward: the training
        forward (``linear_kw["training"]``), or gradients on and x
        requiring them (a LoRA step)."""
        return bool(linear_kw.get("training")) or (
            torch.is_grad_enabled() and x.requires_grad)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the block's input, the router's logits) as this rank's
        experts read it: the rank's backward gives only its experts' share
        of the gradient, which ``comm.enter`` sums over the ep group, so
        that every rank holds the whole one (and the router's weight and
        everything before the block with it)."""
        return comm.enter(t, self.mesh.ep_group)
