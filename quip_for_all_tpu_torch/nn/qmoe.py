"""Stacked-expert MoE layers: top-K sparse decode over lattice-coded
experts — counterpart of ``quip_for_all_tpu/nn/qmoe.py``.

Every expert weight array is stacked along a leading E axis, which gives:

  1. sparse decode (``moe_sparse_apply``): (token, slot) pairs become
     R = m*K rows, each carrying its expert id; the per-row incoherence
     transforms gather the stacked SU/hadK, and the core matmul is the
     expert-indexed kernel (``ops/moe_matmul.py``), which reads only the
     selected experts' planes, once per distinct expert;
  2. per-expert unstacked views (``unstack_qlinear``) for the dense masked
     prefill loop in ``models/llama.py``.

The dense all-experts formulation for expert-parallel meshes
(``moe_dense_stacked_apply``) waits for the parallelism slice. The MoE
kernel decodes nibble planes: stacking re-lays paired, bfp and sw experts
to nibble as the JAX package does, and refuses u3/pb experts, which the
JAX package stacks unconverted (ROADMAP.md queue 3).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_matmul import grouped_permute
from ..ops.moe_matmul import moe_fused_matmul, moe_fused_matmul_ref
from ..ops.qtensor import (ROWPAIR_LAYOUTS, QuantizedTensor,
                           decode_affine, to_nibble)
from ..transforms.incoherence import hadamard_transform
from .qlinear import QuantLinear, same_tensor


class StackedQuantLinear(nn.Module):
    """E experts' worth of one linear (or a fused segment group like
    w1+w3) with identical geometry, stacked on a leading expert axis.

    Segments within an expert share that expert's left transform; the
    per-expert wscale and per-channel Wscale fold into ``pre_vec``, applied
    on the output side after the kernel's cast."""

    def __init__(self, planes: Dict[str, torch.Tensor], *, SU, had_left,
                 pre_vec, had_right, SV_all, bias_all, E: int, nseg: int,
                 in_features: int, q_in: int, seg_out: int, K_left: int,
                 K_right: int, codebook_id: str, opt_resid_scale: float):
        super().__init__()
        self.plane_keys = sorted(planes)
        for k in self.plane_keys:                    # (E, nseg*seg_out, Gp)
            self.register_buffer(f"planes_{k}", planes[k])
        for name, t in (("SU", SU),                  # (E, q_in)
                        ("had_left", had_left),      # (E, K_l, K_l)
                        ("pre_vec", pre_vec),        # (E, nseg*seg_out) f32
                        ("had_right", had_right),    # (E, nseg, K_r, K_r)
                        ("SV_all", SV_all),          # (E, nseg*seg_out)
                        ("bias_all", bias_all)):     # (E, nseg*seg_out)
            self.register_buffer(name, t)
        self.E, self.nseg = E, nseg
        self.in_features, self.q_in, self.seg_out = in_features, q_in, seg_out
        self.K_left, self.K_right = K_left, K_right
        self.codebook_id = codebook_id
        self.opt_resid_scale = opt_resid_scale
        # split-K chunks for the per-expert views of the dense prefill loop
        self.ksplit = 0

    @property
    def q_out_total(self) -> int:
        return self.nseg * self.seg_out

    @property
    def planes(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"planes_{k}") for k in self.plane_keys}

    def plane_list(self) -> List[torch.Tensor]:
        return [getattr(self, f"planes_{k}") for k in self.plane_keys]


def _stackable(groups: List[List[QuantLinear]]) -> bool:
    """All experts' segment groups uniform + per-group shared left side."""
    if not groups or not groups[0]:
        return False
    p00 = groups[0][0]
    nseg = len(groups[0])
    for g in groups:
        if len(g) != nseg:
            return False
        for p in g:
            if not isinstance(p, QuantLinear):
                return False
            if (p.q_in != p00.q_in or p.q_out != p00.q_out
                    or p.out_features != p.q_out
                    or p.in_features != p00.in_features
                    or p.K_left != p00.K_left or p.K_right != p00.K_right
                    or p.codebook_id != p00.codebook_id
                    or p.layout != p00.layout
                    or (p.SU is None) != (p00.SU is None)
                    or (p.SV is None) != (p00.SV is None)
                    or (p.bias is None) != (p00.bias is None)
                    or (p.had_left is None) != (p00.had_left is None)
                    or (p.had_right is None) != (p00.had_right is None)):
                return False
        # segments of one expert must share the expert's left transform
        if not all(same_tensor(p.SU, g[0].SU)
                   and same_tensor(p.had_left, g[0].had_left)
                   for p in g[1:]):
            return False
    return True


def stack_qlinears(groups: List[List[QuantLinear]]
                   ) -> Optional[StackedQuantLinear]:
    """[[seg0, seg1, ...] per expert] -> StackedQuantLinear, or None when
    the geometry is not uniform (caller keeps the per-expert list)."""
    if not _stackable(groups):
        return None
    p0 = groups[0][0]
    if p0.layout in ROWPAIR_LAYOUTS:
        # the MoE kernel decodes nibble planes only. (The JAX package's
        # stack_qlinears lets u3/pb through unchanged: ROADMAP.md queue 3.)
        raise NotImplementedError(
            f"stacking {p0.layout} experts: the MoE kernel takes the nibble "
            "layout, and u3/pb experts do not convert (load Mixtral with "
            "layout None, 'paired', 'bfp', 'sw2' or 'sw4')")
    # paired / bfp / sw experts re-lay to nibble planes (exact), as the JAX
    # package's stack_qlinears does (nn/qmoe.py:119-133 there)
    qws = [[to_nibble(p.qweight) for p in g] for g in groups]
    planes = {k: torch.stack([torch.cat([q.planes[k] for q in g])
                              for g in qws])
              for k in sorted(qws[0][0].planes)}
    SU = (torch.stack([g[0].SU for g in groups])
          if p0.SU is not None else None)
    had_left = (torch.stack([g[0].had_left for g in groups])
                if p0.had_left is not None else None)
    dev = planes["w0"].device

    def expert_pre(g):
        parts = []
        for p in g:
            v = torch.full((p.q_out,), p.wscale_float, dtype=torch.float32,
                           device=dev)
            if p.per_channel:
                v = v * p.Wscale.to(torch.float32)
            parts.append(v)
        return torch.cat(parts)

    def per_expert_cat(attr):
        if getattr(p0, attr) is None:
            return None
        return torch.stack([torch.cat([getattr(p, attr).to(torch.float32)
                                       for p in g]) for g in groups])

    had_right = (torch.stack([torch.stack([p.had_right for p in g])
                              for g in groups])
                 if p0.had_right is not None else None)
    return StackedQuantLinear(
        planes, SU=SU, had_left=had_left,
        pre_vec=torch.stack([expert_pre(g) for g in groups]),
        had_right=had_right, SV_all=per_expert_cat("SV"),
        bias_all=per_expert_cat("bias"), E=len(groups), nseg=len(groups[0]),
        in_features=p0.in_features, q_in=p0.q_in, seg_out=p0.q_out,
        K_left=p0.K_left, K_right=p0.K_right, codebook_id=p0.codebook_id,
        opt_resid_scale=p0.opt_resid_scale)


def unstack_qlinear(sq: StackedQuantLinear, e: int) -> List[QuantLinear]:
    """Per-expert segment views (no copy) — used by the dense prefill loop,
    so stacked params keep a single copy of the planes."""
    outs = []
    for s in range(sq.nseg):
        lo, hi = s * sq.seg_out, (s + 1) * sq.seg_out
        planes = {k: v[e, lo:hi] for k, v in sq.planes.items()}
        qt = QuantizedTensor(planes, sq.codebook_id, sq.seg_out, sq.q_in,
                             sq.opt_resid_scale)
        outs.append(QuantLinear(
            qt, in_features=sq.in_features, out_features=sq.seg_out,
            q_in=sq.q_in, q_out=sq.seg_out, K_left=sq.K_left,
            K_right=sq.K_right,
            SU=None if sq.SU is None else sq.SU[e],
            SV=None if sq.SV_all is None else sq.SV_all[e, lo:hi],
            bias=None if sq.bias_all is None else sq.bias_all[e, lo:hi],
            had_left=None if sq.had_left is None else sq.had_left[e],
            had_right=None if sq.had_right is None else sq.had_right[e, s],
            Wscale=sq.pre_vec[e, lo:hi], per_channel=True,
            wscale_float=1.0))
        # a fresh view takes the stack's split-K: no layer's switch changes
        outs[-1]._switches["ksplit"] = sq.ksplit
    return outs


# ----------------------------------------------------------- row transforms

def _left_transform_rows(sq: StackedQuantLinear, x: torch.Tensor,
                         eids: torch.Tensor) -> torch.Tensor:
    """x (R, in_features) -> (R, q_in) in each row's expert basis (U^T x,
    unscaled: the wscale lives in pre_vec on the output side)."""
    R, n = x.shape
    if n != sq.q_in:
        x = F.pad(x, (0, sq.q_in - n))
    K, M = sq.K_left, sq.q_in // sq.K_left
    Y = hadamard_transform(x.reshape(R, K, M), 1.0 / math.sqrt(M))
    if K > 1:
        hadK = sq.had_left.index_select(0, eids).to(Y.dtype)
        # hadUt: out_j = sum_k Y_k hadK[k, j]
        Y = torch.einsum("rkm,rkj->rjm", Y, hadK)
    return Y.reshape(R, sq.q_in)


def _right_transform_rows(sq: StackedQuantLinear, y: torch.Tensor,
                          eids: torch.Tensor) -> torch.Tensor:
    """y (R, nseg*seg_out) pre-transformed -> output basis per row."""
    R = y.shape[0]
    K, M = sq.K_right, sq.seg_out // sq.K_right
    Y = hadamard_transform(y.reshape(R, sq.nseg, K, M), 1.0 / math.sqrt(M))
    if K > 1:
        hadK = sq.had_right.index_select(0, eids).to(Y.dtype)
        # hadU: out_j = sum_k hadK[j, k] Y_k
        Y = torch.einsum("rskm,rsjk->rsjm", Y, hadK)
    return Y.reshape(R, sq.nseg * sq.seg_out)


def stacked_rows_apply(sq: StackedQuantLinear, x: torch.Tensor,
                       eids: torch.Tensor, *, rows_per_expert: int,
                       compute_dtype=torch.bfloat16,
                       matmul_impl: str = "auto") -> torch.Tensor:
    """x: (R, in_features) rows, eids: (R,) int32 expert per row ->
    (R, nseg*seg_out). The full QuantLinear pipeline with every per-expert
    table gathered per row. The core is the expert-indexed kernel
    (``rows_per_expert``: see ``moe_fused_matmul``) at every shape;
    ``matmul_impl="plain"`` takes its plain twin, the role of the JAX
    package's XLA ``_decode_rows_matmul``.
    """
    dt = x.dtype
    if sq.SU is not None:
        x = x * sq.SU.index_select(0, eids).to(dt)
    xt = _left_transform_rows(sq, x, eids)
    planes = sq.plane_list()
    x_perm = grouped_permute(xt, planes[0].shape[-1]).to(
        compute_dtype).contiguous()
    affine = decode_affine(sq.codebook_id, sq.opt_resid_scale)
    if matmul_impl == "plain":
        out = moe_fused_matmul_ref(x_perm, eids, planes, affine)
    else:
        out = moe_fused_matmul(x_perm, eids, planes, affine, rows_per_expert)
    out = out.to(dt) * sq.pre_vec.index_select(0, eids).to(dt)
    out = _right_transform_rows(sq, out, eids)
    if sq.SV_all is not None:
        out = out * sq.SV_all.index_select(0, eids).to(dt)
    if sq.bias_all is not None:
        out = out + sq.bias_all.index_select(0, eids).to(dt)
    return out


# ----------------------------------------------------------- MoE layers

def moe_sparse_apply(cfg, moe_p, x: torch.Tensor,
                     router_logits: torch.Tensor, *,
                     compute_dtype=torch.bfloat16,
                     matmul_impl: str = "auto") -> torch.Tensor:
    """Top-K routed MoE over stacked experts. x: (B, S, D)."""
    st = moe_p["experts_stacked"]
    B, S, D = x.shape
    m = B * S
    Kt = cfg.num_experts_per_tok
    topv, topi = torch.topk(
        router_logits.reshape(m, -1).to(torch.float32), Kt, dim=-1)
    topw = torch.softmax(topv, dim=-1)                     # (m, K)
    x_rows = x.reshape(m, D).repeat_interleave(Kt, dim=0)  # (m*K, D)
    eids = topi.reshape(-1).to(torch.int32)
    # the top-K ids of one token are distinct: an expert has at most m rows
    kw = dict(compute_dtype=compute_dtype, matmul_impl=matmul_impl,
              rows_per_expert=m)
    h = stacked_rows_apply(st["w13"], x_rows, eids, **kw)
    g, u = h.chunk(2, dim=-1)
    act = F.silu(g.to(torch.float32)).to(h.dtype) * u
    y = stacked_rows_apply(st["w2"], act, eids, **kw)     # (m*K, D')
    y = y.reshape(m, Kt, -1) * topw[..., None].to(y.dtype)
    return y.sum(dim=1).reshape(B, S, -1).to(x.dtype)


def stack_experts(moe_p) -> Optional[Dict[str, StackedQuantLinear]]:
    """Per-expert {w1, w3, w2} list -> {"w13": ..., "w2": ...} stacked
    containers, or None if any expert is not uniformly quantized."""
    experts = moe_p["experts"] if "experts" in moe_p else None
    if not experts:
        return None
    w13 = stack_qlinears([[e["w1"], e["w3"]] for e in experts])
    w2 = stack_qlinears([[e["w2"]] for e in experts])
    if w13 is None or w2 is None:
        return None
    return {"w13": w13, "w2": w2}
