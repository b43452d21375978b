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

The backward (K3, ``csrc/fused_decode_matmul_bwd.cu``, the custom VJP
``_fused_core_bwd`` at ``dequant_pallas.py:970``) runs when autograd asks
for it: ``fused_quant_matmul_pre`` enters ``FusedQuantMatmul`` only when
gradients are on and x_perm or scale_vec requires grad (a LoRA step through
the frozen quantized base), so decode launches and CUDA-graph capture stay
as they were. It gives

    dx = ((g * scale_vec) @ W) in x_perm's lane order, zero in pad lanes
    d scale_vec = sum over rows of g * (x_perm @ W^T, in f32, no scale)

with W decoded from the nibble words; the other layouts re-lay to nibble
words first (``to_nibble``, exact) and dx comes back in their lane order.
The planes take no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .dequant import nibble_planes
from .layout_matmul import (bfp_decode_matmul, bfp_decode_matmul_ref,
                            check_call, ksplit_decode_matmul,
                            ksplit_decode_matmul_ref, launch, pick_ksplit,
                            sw_decode_matmul, sw_decode_matmul_ref)
from .qtensor import UCODE_LAYOUTS, QuantizedTensor, to_nibble
from .rowpair_matmul import (paired_decode_matmul, rowpair_matmul_ref,
                             rowpair_pb_matmul, rowpair_u3_matmul)

KERNEL = "fused_decode_matmul"
BWD_KERNEL = "fused_decode_matmul_bwd"


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


def fused_decode_matmul_bwd_ref(g: torch.Tensor,
                                planes: Sequence[torch.Tensor], affine,
                                scale_vec: Optional[torch.Tensor], G: int,
                                Gp_out: int, split: int = 1) -> torch.Tensor:
    """Plain twin of K3, the body of ``_fused_core_bwd`` in torch: W decoded
    densely in f32 from the nibble words in ``decode_positions``' order of
    operations (the kernel's too), ``gs @ W`` with gs = g * scale_vec in
    f32, then the grouped permutation with zero pad lanes."""
    gs = g.to(torch.float32)
    if scale_vec is not None:
        gs = gs * scale_vec.to(torch.float32)
    W = None
    for (alpha, _), w in zip(affine, planes):
        t = alpha * torch.stack(nibble_planes(w[:, :G]), dim=-1)
        W = t if W is None else W + t
    W = (W + float(sum(b for _, b in affine))).reshape(W.shape[0], 8 * G)
    return grouped_permute(gs @ W, Gp_out, split).to(g.dtype)


def fused_decode_matmul_bwd(g: torch.Tensor, planes: Sequence[torch.Tensor],
                            affine, scale_vec: Optional[torch.Tensor],
                            G: int, Gp_out: int, split: int = 1
                            ) -> torch.Tensor:
    """K3 wrapper: g (m, q_out) f32 or bf16 and 1 or 2 nibble word planes
    (q_out, Gn) -> dx (m, 8*Gp_out) in g's dtype, in the lane order of
    subword split ``split`` (``grouped_permute``), zero in the lanes of
    groups G..Gp_out-1. ``.launches`` counts kernel launches (plain-twin
    calls on CPU tensors are not counted)."""
    if g.dim() != 2 or not g.is_contiguous():
        raise ValueError("g must be a contiguous 2-D tensor")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g dtype {g.dtype} (want f32 or bf16)")
    m, q_out = g.shape
    if len(planes) not in (1, 2) or len(affine) != len(planes):
        raise ValueError("the kernel takes 1 or 2 plane sets, each with its "
                         "(alpha, beta)")
    Gn = planes[0].shape[-1]
    if not (1 <= G <= min(Gn, Gp_out)) or split not in (1, 2, 4):
        raise ValueError(f"G={G} outside 1..min(Gn={Gn}, Gp_out={Gp_out}) "
                         f"or split {split} not in (1, 2, 4)")
    for w in planes:
        if (w.dtype != torch.int32 or tuple(w.shape) != (q_out, Gn)
                or not w.is_contiguous() or w.device != g.device):
            raise ValueError(f"planes must be contiguous int32 ({q_out}, Gn)"
                             " tensors on g's device")
    if scale_vec is not None and (
            scale_vec.dtype != torch.float32 or scale_vec.shape != (q_out,)
            or not scale_vec.is_contiguous()
            or scale_vec.device != g.device):
        raise ValueError("scale_vec must be a contiguous f32 (q_out,) "
                         "tensor on g's device")
    if g.device.type == "cpu":
        return fused_decode_matmul_bwd_ref(g, planes, affine, scale_vec, G,
                                           Gp_out, split)
    if g.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {g.device}")
    from ._build import load
    fn = load(BWD_KERNEL).qfa_fused_decode_matmul_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    dx = torch.empty((m, 8 * Gp_out), dtype=g.dtype, device=g.device)
    alphas = [float(a) for a, _ in affine] + [0.0]
    err = fn(g.data_ptr(),
             scale_vec.data_ptr() if scale_vec is not None else None,
             planes[0].data_ptr(),
             planes[1].data_ptr() if len(planes) > 1 else None,
             dx.data_ptr(), m, q_out, Gn, G, Gp_out, split, len(planes),
             alphas[0], alphas[1], float(sum(b for _, b in affine)),
             int(g.dtype == torch.bfloat16),
             torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError {err}")
    fused_decode_matmul_bwd.launches += 1
    return dx


fused_decode_matmul_bwd.launches = 0


def quant_matmul_bwd(g: torch.Tensor, qt: QuantizedTensor,
                     scale_vec: Optional[torch.Tensor] = None,
                     plain: bool = False) -> torch.Tensor:
    """dx of ``fused_quant_matmul_pre`` for any layout: K3 (or with
    ``plain`` its twin) on the nibble words of the same codes, dx in the
    layout's own lane order and Gp. The re-layout is exact (a view for
    sw2/sw4, a copy for bfp and the u-code layouts)."""
    qn = to_nibble(qt)
    fn = fused_decode_matmul_bwd_ref if plain else fused_decode_matmul_bwd
    if scale_vec is not None:
        scale_vec = scale_vec.to(torch.float32).contiguous()
    return fn(g.contiguous(), [w.contiguous() for w in qn.plane_list()],
              qn.decode_affine, scale_vec, qt.q_in // 8, qt.group_cols,
              qt.split)


class FusedQuantMatmul(torch.autograd.Function):
    """``fused_quant_matmul_pre`` with K3 as its backward (the JAX
    package's ``_fused_core`` custom VJP). Inputs: x_perm (m, 8*Gp),
    scale_vec or None, the QuantizedTensor, ``plain`` and ``ksplit``."""

    @staticmethod
    def forward(ctx, x_perm, scale_vec, qt, plain, ksplit):
        ctx.qt, ctx.plain, ctx.ksplit = qt, plain, ksplit
        ctx.x_dtype = x_perm.dtype
        # x only when d scale_vec needs out0 = x_perm @ W^T
        ctx.save_for_backward(x_perm if ctx.needs_input_grad[1] else None,
                              scale_vec)
        return _forward(x_perm, qt, scale_vec, plain, ksplit)

    @staticmethod
    def backward(ctx, g):
        x_perm, scale_vec = ctx.saved_tensors
        qt, plain = ctx.qt, ctx.plain
        dx = ds = None
        if ctx.needs_input_grad[1]:
            # JAX's order (dequant_pallas.py:993-1001): out0 in f32 with no
            # scale, by the layout's forward kernel on x_perm cast to f32
            out0 = _forward(x_perm.to(torch.float32), qt, None, plain,
                            ctx.ksplit)
            ds = (g.to(torch.float32) * out0).sum(dim=0).to(scale_vec.dtype)
        if ctx.needs_input_grad[0]:
            dx = quant_matmul_bwd(g, qt, scale_vec, plain).to(ctx.x_dtype)
        return dx, ds, None, None, None


def supports(qt: QuantizedTensor) -> bool:
    """The JAX package's shape rule for the fused route (it keeps
    q_out % 128 == 0 for its tiling); both packages take the same route.
    The CUDA kernel itself needs no divisibility."""
    return qt.q_out % 128 == 0 and qt.q_in % 8 == 0


def fused_quant_matmul_pre(x_perm: torch.Tensor, qt: QuantizedTensor,
                           scale_vec: Optional[torch.Tensor] = None,
                           plain: bool = False, ksplit: int = 0
                           ) -> torch.Tensor:
    """x already in the layout's grouped lane order (m, 8*Gp) -> (m, q_out)
    (``_forward``). Differentiable in x_perm and scale_vec: with gradients
    on and either of them requiring grad the call goes through
    ``FusedQuantMatmul`` (forward the same kernel, backward K3), as
    ``_fused_core`` does in the JAX package (``dequant_pallas.py:954``);
    every other call runs the forward alone."""
    if x_perm.shape[1] != 8 * qt.group_cols:
        raise ValueError(f"x_perm {tuple(x_perm.shape)} vs Gp "
                         f"{qt.group_cols}")
    if torch.is_grad_enabled() and (
            x_perm.requires_grad
            or (scale_vec is not None and scale_vec.requires_grad)):
        return FusedQuantMatmul.apply(x_perm, scale_vec, qt, plain, ksplit)
    return _forward(x_perm, qt, scale_vec, plain, ksplit)


def _forward(x_perm: torch.Tensor, qt: QuantizedTensor,
             scale_vec: Optional[torch.Tensor], plain: bool, ksplit: int
             ) -> torch.Tensor:
    """The layout's forward kernel. m pads to a
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
