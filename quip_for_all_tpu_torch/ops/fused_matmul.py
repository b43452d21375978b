"""Fused codebook-decode + matmul: the wrapper of the hand-written CUDA
kernel ``csrc/fused_decode_matmul.cu`` and its plain torch twin.

Counterpart of ``quip_for_all_tpu/ops/dequant_pallas.py`` (nibble layout,
split=1): one kernel ports ``_make_kernel`` through both ``_fused_call``
grids (1-D at m <= 32 after the pad, 2-D m-tiled above). The weights never
exist densely in device memory: the int32 word planes stream once and each
nibble is decoded in registers.

    out(m, q_out) = sum_s alpha_s * (x_perm @ nib_s^T)
                    + beta_total * rowsum(x_perm),  times scale_vec per
                    output channel, cast to x_perm's dtype

with x in the grouped layout x_perm[:, i*Gp + g] = x[:, 8g + i] (pad lanes
zero). A CPU tensor takes the plain twin ``fused_decode_matmul_ref``; a CUDA
tensor launches the kernel or the call raises. ``fused_quant_matmul_pre``
dispatches by layout, as ``_fused_call`` does: u3, pb and paired to
``ops/rowpair_matmul.py``, bfp and sw2/sw4 to ``ops/layout_matmul.py``, and
nibble here, or to the split-K kernel there when split-K is asked for.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .layout_matmul import (bfp_decode_matmul, bfp_decode_matmul_ref,
                            check_call, ksplit_decode_matmul,
                            ksplit_decode_matmul_ref, launch, pick_ksplit,
                            sw_decode_matmul, sw_decode_matmul_ref)
from .qtensor import UCODE_LAYOUTS, QuantizedTensor
from .rowpair_matmul import (paired_decode_matmul, rowpair_matmul_ref,
                             rowpair_pb_matmul, rowpair_u3_matmul)

KERNEL = "fused_decode_matmul"


def fused_decode_matmul_ref(x_perm: torch.Tensor,
                            planes: Sequence[torch.Tensor], affine,
                            scale_vec: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain twin of the kernel: the same math in torch ops.

    Products are exact in f32 (bf16/f32 x values times nibbles 0..15) and
    sums run in f32, as in the Pallas kernel at every m."""
    xf = x_perm.to(torch.float32)
    out = None
    for (alpha, _), w in zip(affine, planes):
        # (q_out, 8, Gp) nibble planes -> (q_out, 8*Gp) in x_perm lane order
        nib = torch.stack([((w >> (4 * i)) & 0xF) for i in range(8)], dim=1)
        acc = xf @ nib.reshape(w.shape[0], -1).to(torch.float32).T
        acc = acc * alpha
        out = acc if out is None else out + acc
    beta_total = float(sum(b for _, b in affine))
    out = out + beta_total * xf.sum(dim=1, keepdim=True)
    if scale_vec is not None:
        out = out * scale_vec.to(torch.float32)
    return out.to(x_perm.dtype)


def fused_decode_matmul(x_perm: torch.Tensor,
                        planes: Sequence[torch.Tensor], affine,
                        scale_vec: Optional[torch.Tensor] = None,
                        rows: Optional[int] = None) -> torch.Tensor:
    """Kernel wrapper: (rows, q_out) from the first ``rows`` rows of x_perm
    (default all; the rest may be padding that is never read).
    ``fused_decode_matmul.launches`` counts kernel launches (plain-twin
    calls on CPU tensors are not counted)."""
    rows = x_perm.shape[0] if rows is None else rows
    q_out, Gp = planes[0].shape
    check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp,
               torch.int32, (q_out, Gp))
    if x_perm.device.type == "cpu":
        return fused_decode_matmul_ref(x_perm[:rows], planes, affine,
                                       scale_vec)
    out = launch(KERNEL, "qfa_fused_decode_matmul", x_perm, planes, affine,
                 scale_vec, rows, q_out, Gp)
    fused_decode_matmul.launches += 1
    return out


fused_decode_matmul.launches = 0


def supports(qt: QuantizedTensor) -> bool:
    """The JAX package's shape rule for the fused route (it keeps
    q_out % 128 == 0 for its tiling); both packages take the same route.
    The CUDA kernel itself needs no divisibility."""
    return qt.q_out % 128 == 0 and qt.q_in % 8 == 0


def fused_quant_matmul_pre(x_perm: torch.Tensor, qt: QuantizedTensor,
                           scale_vec: Optional[torch.Tensor] = None,
                           plain: bool = False, ksplit: int = 0
                           ) -> torch.Tensor:
    """x already in the layout's grouped lane order (m, 8*Gp). m pads to a
    multiple of 8 (at least 8) and the result comes back with m rows, as
    in ``dequant_pallas.py:941-951``; the kernels compute only the m real
    rows (the pad is the TPU's 8-sublane tile, which the CUDA kernels do
    not need; the u-code kernels read the padded count only for their
    group-sum rounding, and split-K for its m rule). The layout picks the
    kernel as ``_fused_call`` does (``:775-828``): u3/pb/paired, bfp,
    sw2/sw4, and nibble through split-K (K6) when
    ``pick_ksplit(ksplit, Gp) > 1`` and the padded m is <= 32, else K1/K2.
    ``plain`` runs the chosen kernel's plain twin on any device (used to
    hold the kernel against it)."""
    m = x_perm.shape[0]
    if x_perm.shape[1] != 8 * qt.group_cols:
        raise ValueError(f"x_perm {tuple(x_perm.shape)} vs Gp "
                         f"{qt.group_cols}")
    mp = max(8, -(-m // 8) * 8)
    if mp != m:
        x_perm = torch.nn.functional.pad(x_perm, (0, 0, 0, mp - m))
    x_perm = x_perm.contiguous()
    if scale_vec is not None:
        scale_vec = scale_vec.to(torch.float32).contiguous()
    rs = qt.opt_resid_scale
    if qt.layout in UCODE_LAYOUTS:
        if plain:
            return rowpair_matmul_ref(x_perm, qt.layout, qt.planes, rs,
                                      scale_vec, rows=m)
        if qt.layout == "u3":
            return rowpair_u3_matmul(x_perm, qt.planes, scale_vec, rows=m)
        if qt.layout == "pb":
            return rowpair_pb_matmul(x_perm, qt.planes, rs, scale_vec,
                                     rows=m)
        return paired_decode_matmul(x_perm, qt.planes, rs, scale_vec, rows=m)
    planes, affine = qt.plane_list(), qt.decode_affine
    chunks = pick_ksplit(ksplit, qt.group_cols) if qt.layout == "nibble" \
        else 1
    if qt.layout == "bfp":
        kernel, twin = bfp_decode_matmul, bfp_decode_matmul_ref
    elif qt.split > 1:
        kernel, twin = sw_decode_matmul, sw_decode_matmul_ref
    elif chunks > 1 and mp <= 32:
        if plain:
            return ksplit_decode_matmul_ref(x_perm[:m], planes, affine,
                                            chunks, scale_vec)
        return ksplit_decode_matmul(x_perm, planes, affine, chunks,
                                    scale_vec, rows=m)
    else:
        kernel, twin = fused_decode_matmul, fused_decode_matmul_ref
    if plain:     # the m real rows, as the wrappers give a CPU tensor
        return twin(x_perm[:m], planes, affine, scale_vec)
    return kernel(x_perm, planes, affine, scale_vec, rows=m)


def grouped_permute(x: torch.Tensor, Gp: int, split: int = 1
                    ) -> torch.Tensor:
    """(m, 8G) natural order -> (m, 8*Gp) grouped layout, pad lanes zero:
    natural index 8g + (8/P)*j + q -> lane q*(P*Gp) + P*g + j with
    P = ``split`` (P = 1: 8g + i -> i*Gp + g)."""
    m, q_in = x.shape
    G = q_in // 8
    xp = x.reshape(m, G, split, 8 // split).permute(0, 3, 1, 2)
    if Gp != G:
        xp = torch.nn.functional.pad(xp, (0, 0, 0, Gp - G))
    return xp.reshape(m, 8 * Gp)


def fused_quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                       plain: bool = False, ksplit: int = 0) -> torch.Tensor:
    """x (m, q_in) in natural K order -> (m, q_out)."""
    if x.shape[1] != qt.q_in:
        raise ValueError(f"x width {x.shape[1]} != q_in {qt.q_in}")
    return fused_quant_matmul_pre(
        grouped_permute(x, qt.group_cols, qt.split), qt, plain=plain,
        ksplit=ksplit)
