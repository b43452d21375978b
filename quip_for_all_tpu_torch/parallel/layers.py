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
f32 result over its ep group (one ``all_reduce``) before the cast.

A layer's ``view`` says what the model reads from a column-parallel
output: ``"chunk"`` (the rank's contiguous rows: its heads, or its slice
of an MLP's hidden width), ``"full"`` (the whole output: attention whose
heads do not split over the ranks, the head's logits), or a tuple of
segment widths (``[q|k|v]`` laid out contiguously, as GPT-2's ``c_attn``
or Baichuan's ``W_pack``: the rank reads its slice of each segment). A
row-parallel layer's ``in_local`` says whether its input arrives as the
rank's slice or whole. A layer that does not split (``cut`` false) keeps
the whole weight and runs on the whole input, as GSPMD replicates it.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..nn.qlinear import (FusedQuantLinear, QuantLinear, fused_left,
                          fused_right, left_product, right_side)
from ..ops.quant_matmul import FUSED_MAX_M, quant_matmul
from ..transforms.incoherence import matmul_hadUt
from . import comm

View = Union[str, tuple]


def _dense(lin, x: torch.Tensor) -> torch.Tensor:
    """``linear_apply``'s dense product without the bias: products of
    x-dtype values summed in f32, as f32."""
    w = lin.weight.to(x.dtype).to(torch.float32)
    return torch.matmul(x.to(torch.float32), w.T)


def _quant_kw(kw: dict) -> dict:
    if kw.get("training") or kw.get("dense_weight") is not None:
        raise NotImplementedError(
            "the training forward under a mesh (LoRA and finetunes run "
            "unsharded)")
    return dict(compute_dtype=kw.get("compute_dtype", torch.bfloat16),
                matmul_impl=kw.get("matmul_impl", "auto"),
                max_m=kw.get("max_m", FUSED_MAX_M))


class _Parallel(nn.Module):
    def __init__(self, local: nn.Module, mesh):
        super().__init__()
        self.local = local
        self.mesh = mesh
        self.tp, self.rank = mesh.tp, mesh.tp_rank

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(t, self.mesh.tp_group, self.tp)

    def _own(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's slice of the last axis (of width n)."""
        w = n // self.tp
        return t[..., self.rank * w:(self.rank + 1) * w]


class ColParallel(_Parallel):
    """A column-parallel linear (see the module docstring): ``local`` the
    rank's rows (or the whole layer when not ``cut``), ``full`` the whole
    layer's right side without planes, for the gathering route."""

    def __init__(self, local: nn.Module, mesh, *, cut: bool,
                 right_local: bool, view: View,
                 full: nn.Module = None, seg_out: Sequence[int] = ()):
        super().__init__(local, mesh)
        self.cut, self.right_local, self.view = cut, right_local, view
        self.full = full
        # a fused group's segment widths (whole), for its gather
        self.seg_out = tuple(seg_out)

    def _select(self, y: torch.Tensor) -> torch.Tensor:
        """The model's view of a whole output."""
        if self.view == "full":
            return y
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
        if not self.cut:
            if isinstance(lin, FusedQuantLinear):
                return [self._select(y) for y in lin(x, **_quant_kw(kw))]
            from ..models.llama import linear_apply
            return self._select(linear_apply(lin, x, **kw))
        if isinstance(lin, FusedQuantLinear):
            return self._fused(x, kw)
        if not isinstance(lin, QuantLinear):          # dense rows
            y = _dense(lin, x).to(x.dtype)
            if lin.bias is not None:
                y = y + lin.bias.to(y.dtype)
            return self._from_rows(y)
        qkw = _quant_kw(kw)
        if self.right_local:
            return self._from_rows(lin(x, **qkw))
        batch = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if lin.SU is not None:
            x2 = x2 * lin.SU.to(x2.dtype)
        out, _ = left_product(lin, x2, **qkw)
        out = self._gather(out.to(x2.dtype))
        return self._select(right_side(self.full, out, False, batch))

    def _fused(self, x: torch.Tensor, kw: dict):
        lin = self.local
        qkw = _quant_kw(kw)
        if self.right_local:
            outs = lin(x, **qkw)
            if self.view == "chunk":
                return outs
            return [self._gather(y) for y in outs]
        batch = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if lin.SU is not None:
            x2 = x2 * lin.SU.to(x2.dtype)
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
            return [self._own(y, y.shape[-1]) for y in outs]
        return outs


class RowParallel(_Parallel):
    """A row-parallel linear (see the module docstring): ``local`` the
    rank's plane columns with the whole right side (or the whole layer
    when not ``cut``), ``full`` the whole layer's left side without
    planes, for the route that transforms the whole input."""

    def __init__(self, local: nn.Module, mesh, *, cut: bool,
                 left_local: bool, in_local: bool, in_features: int,
                 full: nn.Module = None):
        super().__init__(local, mesh)
        self.cut, self.left_local, self.in_local = cut, left_local, in_local
        self.in_features = in_features
        self.full = full

    def _whole_input(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x) if self.in_local else x

    def _own_input(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.in_local else self._own(x, self.in_features)

    def forward(self, x: torch.Tensor, **kw):
        lin = self.local
        if not self.cut:
            from ..models.llama import linear_apply
            return linear_apply(lin, self._whole_input(x), **kw)
        if not isinstance(lin, QuantLinear):          # dense columns
            part = comm.all_reduce(_dense(lin, self._own_input(x)),
                                   self.mesh.tp_group)
            y = part.to(x.dtype)
            if lin.bias is not None:
                y = y + lin.bias.to(y.dtype)
            return y
        qkw = _quant_kw(kw)
        batch, x_dtype = x.shape[:-1], x.dtype
        if self.left_local:
            xl = self._own_input(x).reshape(-1, lin.q_in)
            if lin.SU is not None:
                xl = xl * lin.SU.to(x_dtype)
            part, _ = left_product(lin, xl, scaled=False, **qkw)
        else:
            full = self.full
            xf = self._whole_input(x).reshape(-1, full.in_features)
            if full.SU is not None:
                xf = xf * full.SU.to(x_dtype)
            xt = matmul_hadUt(xf, full.left_spec, scale=full.wscale_float)
            xl = self._own(xt, full.q_in)
            part = quant_matmul(xl.to(qkw["compute_dtype"]), lin.qweight,
                                impl=qkw["matmul_impl"], max_m=qkw["max_m"],
                                ksplit=lin.ksplit, combine=lin.combine)
        out = comm.all_reduce(part.to(torch.float32).contiguous(),
                              self.mesh.tp_group).to(x_dtype)
        if lin.per_channel:
            out = out * lin.Wscale.to(x_dtype)
        return right_side(lin, out, False, batch)


class ExpertParallelMoE(nn.ModuleDict):
    """A rank's Mixtral MoE block over the "ep" axis: the router ``gate``
    (replicated) and ``experts_stacked`` (``w13``, ``w2``) holding experts
    [offset, offset + E/ep) of the model's E, whole (the tp ranks of one
    ep index hold the same experts). ``models/llama.py`` ``moe_apply``
    runs it through ``nn/qmoe.py`` ``moe_dense_stacked_apply``, routing
    over all E experts, with ``combine`` as its ``reduce``."""

    def __init__(self, gate: nn.Module, w13: nn.Module, w2: nn.Module, *,
                 offset: int, mesh):
        super().__init__({"gate": gate, "experts_stacked": nn.ModuleDict(
            {"w13": w13, "w2": w2})})
        self.offset = offset
        self.mesh = mesh

    def combine(self, partial: torch.Tensor) -> torch.Tensor:
        """The f32 partial output of this rank's experts summed over its
        ep group, the other experts' ranks."""
        return comm.all_reduce(partial.contiguous(), self.mesh.ep_group)
