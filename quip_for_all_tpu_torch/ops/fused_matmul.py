"""Fused codebook-decode + matmul: the wrappers of the hand-written CUDA
kernels ``csrc/fused_decode_matmul.cu`` (K1) and
``csrc/fused_decode_matmul_tc.cu`` (K2) and their plain torch twin.

Counterpart of ``quip_for_all_tpu/ops/dequant_pallas.py`` (nibble layout,
split=1), ``_make_kernel`` through ``_fused_call``'s two grids: calls of at
most 32 rows after the pad to 8 (the 1-D grid, decode and short prompts)
launch K1, which decodes each plane word once for all its rows straight
into tensor-core operand registers (``csrc/nibble_mma_small.cuh``, shared
with K11); larger calls (the 2-D m-tiled grid: prefill, training) launch
K2, which decodes each plane slab once per tile of 64-128 rows into shared
memory. Both multiply on the tensor cores. The weights never exist densely
in device memory.

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
                            check_call, combined_sum, ksplit_decode_matmul,
                            ksplit_decode_matmul_ref, launch, pick_ksplit,
                            right_epilogue, sw_decode_matmul,
                            sw_decode_matmul_ref)
from .qtensor import UCODE_LAYOUTS, QuantizedTensor, to_nibble
from .rowpair_matmul import (paired_decode_matmul, pallas_block_rows,
                             rowpair_matmul_ref, rowpair_pb_matmul,
                             rowpair_u3_matmul)

KERNEL = "fused_decode_matmul"
TC_KERNEL = "fused_decode_matmul_tc"
BWD_KERNEL = "fused_decode_matmul_bwd"
# K1 takes calls of up to this many rows, K2 the larger ones: the padded m
# at which the JAX package leaves its 1-D grid for the 2-D m-tiled one
# (TM = min(m, 32), dequant_pallas.py:852)
K1_MAX_ROWS = 32


def fused_decode_matmul_ref(x_perm: torch.Tensor,
                            planes: Sequence[torch.Tensor], affine,
                            scale_vec: Optional[torch.Tensor] = None,
                            right_hb: Optional[torch.Tensor] = None,
                            combine: bool = False) -> torch.Tensor:
    """Plain twin of the kernel: the same math in torch ops.

    Products are exact in f32 (bf16/f32 x values times nibbles 0..15) and
    sums run in f32, as in the Pallas kernel at every m. ``combine`` takes
    the combined branch (``combined_sum``), ``right_hb`` the right
    epilogue (``right_epilogue``)."""
    xf = x_perm.to(torch.float32)

    def nibs(w):
        # (q_out, 8, Gp) nibble planes -> (q_out, 8*Gp) in x_perm lane order
        nib = torch.stack([((w >> (4 * i)) & 0xF) for i in range(8)], dim=1)
        return nib.reshape(w.shape[0], -1).to(torch.float32)
    if combine:
        out = combined_sum(xf, [(xf, nibs(planes[0]))],
                           [(xf, nibs(planes[1]))], affine)
    else:
        out = None
        for (alpha, _), w in zip(affine, planes):
            acc = (xf @ nibs(w).T) * alpha
            out = acc if out is None else out + acc
    beta_total = float(sum(b for _, b in affine))
    out = out + beta_total * xf.sum(dim=1, keepdim=True)
    if scale_vec is not None:
        out = out * scale_vec.to(torch.float32)
    return right_epilogue(out.to(x_perm.dtype), right_hb)


def fused_decode_matmul(x_perm: torch.Tensor,
                        planes: Sequence[torch.Tensor], affine,
                        scale_vec: Optional[torch.Tensor] = None,
                        rows: Optional[int] = None,
                        right_hb: Optional[torch.Tensor] = None,
                        combine: bool = False) -> torch.Tensor:
    """Kernel wrapper: (rows, q_out) from the first ``rows`` rows of x_perm
    (default all; the rest may be padding that is never read). Calls of
    more than ``K1_MAX_ROWS`` rows go to K2 (``fused_decode_matmul_tc``,
    counted there), the rest launch K1, counted in
    ``fused_decode_matmul.launches`` (plain-twin calls on CPU tensors are
    not counted). ``right_hb`` and ``combine`` run the right epilogue and
    the combined decode inside the kernel."""
    rows = x_perm.shape[0] if rows is None else rows
    if rows > K1_MAX_ROWS:
        return fused_decode_matmul_tc(x_perm, planes, affine, scale_vec,
                                      rows, right_hb, combine)
    q_out, Gp = planes[0].shape
    check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp,
               torch.int32, (q_out, Gp), right_hb, combine)
    if x_perm.device.type == "cpu":
        return fused_decode_matmul_ref(x_perm[:rows], planes, affine,
                                       scale_vec, right_hb, combine)
    out = launch(KERNEL, "qfa_fused_decode_matmul_ex", x_perm, planes, affine,
                 scale_vec, rows, q_out, Gp, right_hb=right_hb,
                 combine=combine)
    fused_decode_matmul.launches += 1
    return out


fused_decode_matmul.launches = 0


def fused_decode_matmul_tc(x_perm: torch.Tensor,
                           planes: Sequence[torch.Tensor], affine,
                           scale_vec: Optional[torch.Tensor] = None,
                           rows: Optional[int] = None,
                           right_hb: Optional[torch.Tensor] = None,
                           combine: bool = False) -> torch.Tensor:
    """K2 wrapper: the function of ``fused_decode_matmul`` (same twin) on
    the tensor-core kernel, at any number of rows; ``fused_decode_matmul``
    sends it the calls of more than ``K1_MAX_ROWS`` rows.
    ``fused_decode_matmul_tc.launches`` counts kernel launches (plain-twin
    calls on CPU tensors are not counted)."""
    rows = x_perm.shape[0] if rows is None else rows
    q_out, Gp = planes[0].shape
    check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp,
               torch.int32, (q_out, Gp), right_hb, combine)
    if x_perm.device.type == "cpu":
        return fused_decode_matmul_ref(x_perm[:rows], planes, affine,
                                       scale_vec, right_hb, combine)
    out = launch(TC_KERNEL, "qfa_fused_decode_matmul_tc_ex", x_perm, planes,
                 affine, scale_vec, rows, q_out, Gp, right_hb=right_hb,
                 combine=combine)
    fused_decode_matmul_tc.launches += 1
    return out


fused_decode_matmul_tc.launches = 0


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
                     plain: bool = False,
                     right_hb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx of ``fused_quant_matmul_pre`` for any layout: K3 (or with
    ``plain`` its twin) on the nibble words of the same codes, dx in the
    layout's own lane order and Gp. The re-layout is exact (a view for
    sw2/sw4, a copy for bfp and the u-code layouts). With ``right_hb`` g
    is first multiplied by it per block of B channels in f32
    (``right_grad``)."""
    qn = to_nibble(qt)
    fn = fused_decode_matmul_bwd_ref if plain else fused_decode_matmul_bwd
    if scale_vec is not None:
        scale_vec = scale_vec.to(torch.float32).contiguous()
    if right_hb is not None:
        g = right_grad(g, right_hb)
    return fn(g.contiguous(), [w.contiguous() for w in qn.plane_list()],
              qn.decode_affine, scale_vec, qt.q_in // 8, qt.group_cols,
              qt.split)


def right_grad(g: torch.Tensor, right_hb: torch.Tensor) -> torch.Tensor:
    """The gradient through the right epilogue: g (m, q_out) in f32 times
    right_hb per block of B channels (the forward's out2 = t @ Hb^T gives
    dt = g @ Hb), as ``_fused_core_bwd`` does before its products; an XLA
    product outside any Pallas kernel there, a torch product here."""
    m, q_out = g.shape
    B = right_hb.shape[0]
    return (g.to(torch.float32).reshape(m, q_out // B, B)
            @ right_hb.to(torch.float32)).reshape(m, q_out)


class FusedQuantMatmul(torch.autograd.Function):
    """``fused_quant_matmul_pre`` with K3 as its backward (the JAX
    package's ``_fused_core`` custom VJP). Inputs: x_perm (m, 8*Gp),
    scale_vec or None, the QuantizedTensor, ``plain``, ``ksplit``,
    ``right_hb`` or None and ``combine``."""

    @staticmethod
    def forward(ctx, x_perm, scale_vec, qt, plain, ksplit, right_hb,
                combine):
        ctx.qt, ctx.plain, ctx.ksplit = qt, plain, ksplit
        ctx.x_dtype = x_perm.dtype
        # x only when d scale_vec needs out0 = x_perm @ W^T
        ctx.save_for_backward(x_perm if ctx.needs_input_grad[1] else None,
                              scale_vec, right_hb)
        return _forward(x_perm, qt, scale_vec, plain, ksplit, right_hb,
                        combine)

    @staticmethod
    def backward(ctx, g):
        x_perm, scale_vec, right_hb = ctx.saved_tensors
        qt, plain = ctx.qt, ctx.plain
        dx = ds = None
        if right_hb is not None:
            g = right_grad(g, right_hb)
        if ctx.needs_input_grad[1]:
            # JAX's order (dequant_pallas.py:993-1001): out0 in f32 with no
            # scale, by the layout's forward kernel on x_perm cast to f32
            out0 = _forward(x_perm.to(torch.float32), qt, None, plain,
                            ctx.ksplit)
            ds = (g.to(torch.float32) * out0).sum(dim=0).to(scale_vec.dtype)
        if ctx.needs_input_grad[0]:
            dx = quant_matmul_bwd(g, qt, scale_vec, plain).to(ctx.x_dtype)
        return dx, ds, None, None, None, None, None


def supports(qt: QuantizedTensor) -> bool:
    """The JAX package's shape rule for the fused route (it keeps
    q_out % 128 == 0 for its tiling); both packages take the same route.
    The CUDA kernel itself needs no divisibility."""
    return qt.q_out % 128 == 0 and qt.q_in % 8 == 0


def can_fuse_right(qt: QuantizedTensor, B: int) -> bool:
    """Whether the right transform's B-side factor can run in the kernel
    epilogue: the JAX package's rule (``dequant_pallas.py:918-922``), its
    q_out tile a multiple of B. Its ``_pick_tn`` always returns a multiple
    of 128 and ``right_b_factor`` gives B <= 128 (a power of 2), so with
    q_out % 128 == 0 (``supports``) the rule holds for every B > 0; the
    CUDA kernels take any power-of-2 B of 8..128 that divides q_out."""
    return B > 0 and qt.q_out % 128 == 0 and 128 % B == 0


def combine_applies(qt: QuantizedTensor, mp: int, combine: int,
                    chunks: int = 1) -> bool:
    """Whether the combined residual decode runs (QFA_COMBINE_PLANES =
    ``combine`` in the JAX package, ``_make_kernel`` ``:158-163``): two or
    more plane sets in the nibble or sw layouts, outside split-K, and a
    Pallas block of at most ``combine`` rows (the block of the padded
    ``mp``: TM of the 2-D grid above 32 rows)."""
    return (combine > 0 and qt.layout in ("nibble", "sw2", "sw4")
            and len(qt.planes) > 1 and chunks == 1
            and pallas_block_rows(mp) <= combine)


def fused_quant_matmul_pre(x_perm: torch.Tensor, qt: QuantizedTensor,
                           scale_vec: Optional[torch.Tensor] = None,
                           plain: bool = False, ksplit: int = 0,
                           right_hb: Optional[torch.Tensor] = None,
                           combine: int = 0) -> torch.Tensor:
    """x already in the layout's grouped lane order (m, 8*Gp) -> (m, q_out)
    (``_forward``). Differentiable in x_perm and scale_vec: with gradients
    on and either of them requiring grad the call goes through
    ``FusedQuantMatmul`` (forward the same kernel, backward K3), as
    ``_fused_core`` does in the JAX package (``dequant_pallas.py:954``);
    every other call runs the forward alone. ``right_hb`` (B, B) f32 runs
    the right transform's B-side factor in the kernel epilogue (the caller
    finishes with ``finish_right``); ``combine`` is QFA_COMBINE_PLANES'
    row bound (0 off, ``combine_applies``)."""
    if x_perm.shape[1] != 8 * qt.group_cols:
        raise ValueError(f"x_perm {tuple(x_perm.shape)} vs Gp "
                         f"{qt.group_cols}")
    if torch.is_grad_enabled() and (
            x_perm.requires_grad
            or (scale_vec is not None and scale_vec.requires_grad)):
        return FusedQuantMatmul.apply(x_perm, scale_vec, qt, plain, ksplit,
                                      right_hb, combine)
    return _forward(x_perm, qt, scale_vec, plain, ksplit, right_hb, combine)


def _forward(x_perm: torch.Tensor, qt: QuantizedTensor,
             scale_vec: Optional[torch.Tensor], plain: bool, ksplit: int,
             right_hb: Optional[torch.Tensor] = None, combine: int = 0
             ) -> torch.Tensor:
    """The layout's forward kernel. m pads to a
    multiple of 8 (at least 8) and the result comes back with m rows, as
    in ``dequant_pallas.py:941-951``; the kernels compute only the m real
    rows (the pad is the TPU's 8-sublane tile, which the CUDA kernels do
    not need; the u-code kernels read the padded count only for their
    group-sum rounding, split-K for its m rule and the combined decode
    for its block rule). The layout picks the kernel as ``_fused_call``
    does (``:775-828``): u3/pb/paired, bfp, sw2/sw4, and nibble through
    split-K (K6) when ``pick_ksplit(ksplit, Gp) > 1`` and the padded m is
    <= 32, else K1 (m <= 32) or K2 (``fused_decode_matmul`` picks).
    ``plain`` runs the chosen kernel's plain twin on any device (used to
    hold the kernel against it)."""
    m = x_perm.shape[0]
    mp = max(8, -(-m // 8) * 8)
    if mp != m:
        x_perm = torch.nn.functional.pad(x_perm, (0, 0, 0, mp - m))
    x_perm = x_perm.contiguous()
    if scale_vec is not None:
        scale_vec = scale_vec.to(torch.float32).contiguous()
    if right_hb is not None:
        right_hb = right_hb.to(device=x_perm.device,
                               dtype=torch.float32).contiguous()
    rs = qt.opt_resid_scale
    if qt.layout in UCODE_LAYOUTS:
        if plain:
            return rowpair_matmul_ref(x_perm, qt.layout, qt.planes, rs,
                                      scale_vec, rows=m, right_hb=right_hb)
        if qt.layout == "u3":
            return rowpair_u3_matmul(x_perm, qt.planes, scale_vec, rows=m,
                                     right_hb=right_hb)
        if qt.layout == "pb":
            return rowpair_pb_matmul(x_perm, qt.planes, rs, scale_vec,
                                     rows=m, right_hb=right_hb)
        return paired_decode_matmul(x_perm, qt.planes, rs, scale_vec, rows=m,
                                    right_hb=right_hb)
    planes, affine = qt.plane_list(), qt.decode_affine
    chunks = pick_ksplit(ksplit, qt.group_cols) if qt.layout == "nibble" \
        else 1
    split_k = chunks > 1 and mp <= 32
    comb = combine_applies(qt, mp, combine, chunks if split_k else 1)
    if qt.layout == "bfp":
        if plain:
            return bfp_decode_matmul_ref(x_perm[:m], planes, affine,
                                         scale_vec, right_hb)
        return bfp_decode_matmul(x_perm, planes, affine, scale_vec, rows=m,
                                 right_hb=right_hb)
    if split_k:
        if plain:
            return ksplit_decode_matmul_ref(x_perm[:m], planes, affine,
                                            chunks, scale_vec, right_hb)
        return ksplit_decode_matmul(x_perm, planes, affine, chunks,
                                    scale_vec, rows=m, right_hb=right_hb)
    if qt.split > 1:
        kernel, twin = sw_decode_matmul, sw_decode_matmul_ref
    else:
        kernel, twin = fused_decode_matmul, fused_decode_matmul_ref
    if plain:     # the m real rows, as the wrappers give a CPU tensor
        return twin(x_perm[:m], planes, affine, scale_vec, right_hb, comb)
    return kernel(x_perm, planes, affine, scale_vec, rows=m,
                  right_hb=right_hb, combine=comb)


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
                       plain: bool = False, ksplit: int = 0,
                       combine: int = 0) -> torch.Tensor:
    """x (m, q_in) in natural K order -> (m, q_out)."""
    if x.shape[1] != qt.q_in:
        raise ValueError(f"x width {x.shape[1]} != q_in {qt.q_in}")
    return fused_quant_matmul_pre(
        grouped_permute(x, qt.group_cols, qt.split), qt, plain=plain,
        ksplit=ksplit, combine=combine)
