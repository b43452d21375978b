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
sends the row-pair layouts (u3, pb) to ``ops/rowpair_matmul.py`` instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .qtensor import ROWPAIR_LAYOUTS, QuantizedTensor
from .rowpair_matmul import (rowpair_matmul_ref, rowpair_pb_matmul,
                             rowpair_u3_matmul)

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


def _check(x_perm, planes, affine, scale_vec, rows):
    if x_perm.dim() != 2 or not x_perm.is_contiguous():
        raise ValueError("x_perm must be a contiguous 2-D tensor")
    if not 1 <= rows <= x_perm.shape[0]:
        raise ValueError(f"rows={rows} outside 1..{x_perm.shape[0]}")
    if x_perm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_perm dtype {x_perm.dtype} (want f32 or bf16)")
    if len(planes) not in (1, 2) or len(affine) != len(planes):
        raise ValueError("the kernel takes 1 or 2 plane sets, each with "
                         "its (alpha, beta)")
    q_out, Gp = planes[0].shape
    if x_perm.shape[1] != 8 * Gp or Gp % 4 != 0:
        raise ValueError(f"x_perm width {x_perm.shape[1]} != 8*Gp={8 * Gp}"
                         " or Gp not a multiple of 4")
    for w in planes:
        if (w.dtype != torch.int32 or w.shape != (q_out, Gp)
                or not w.is_contiguous() or w.device != x_perm.device):
            raise ValueError("planes must be contiguous int32 (q_out, Gp) "
                             "tensors on x_perm's device")
    if scale_vec is not None and (
            scale_vec.dtype != torch.float32 or scale_vec.shape != (q_out,)
            or not scale_vec.is_contiguous()
            or scale_vec.device != x_perm.device):
        raise ValueError("scale_vec must be a contiguous f32 (q_out,) "
                         "tensor on x_perm's device")


def fused_decode_matmul(x_perm: torch.Tensor,
                        planes: Sequence[torch.Tensor], affine,
                        scale_vec: Optional[torch.Tensor] = None,
                        rows: Optional[int] = None) -> torch.Tensor:
    """Kernel wrapper: (rows, q_out) from the first ``rows`` rows of x_perm
    (default all; the rest may be padding that is never read).
    ``fused_decode_matmul.launches`` counts kernel launches (plain-twin
    calls on CPU tensors are not counted)."""
    rows = x_perm.shape[0] if rows is None else rows
    _check(x_perm, planes, affine, scale_vec, rows)
    if x_perm.device.type == "cpu":
        return fused_decode_matmul_ref(x_perm[:rows], planes, affine,
                                       scale_vec)
    if x_perm.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_perm.device}")
    for t in [x_perm, *planes]:
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x and planes")
    from ._build import load
    lib = load(KERNEL)
    fn = lib.qfa_fused_decode_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
    q_out, Gp = planes[0].shape
    out = torch.empty((rows, q_out), dtype=x_perm.dtype, device=x_perm.device)
    alphas = [float(a) for a, _ in affine] + [0.0]
    beta_total = float(sum(b for _, b in affine))
    stream = torch.cuda.current_stream(x_perm.device).cuda_stream
    err = fn(x_perm.data_ptr(), planes[0].data_ptr(),
             planes[1].data_ptr() if len(planes) > 1 else None,
             scale_vec.data_ptr() if scale_vec is not None else None,
             out.data_ptr(), rows, q_out, Gp, len(planes), alphas[0],
             alphas[1], beta_total,
             int(x_perm.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
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
                           plain: bool = False) -> torch.Tensor:
    """x already in the grouped-permuted layout (m, 8*Gp). m pads to a
    multiple of 8 (at least 8) and the result comes back with m rows, as
    in ``dequant_pallas.py:941-951``; the kernel computes only the m real
    rows (the pad is the TPU's 8-sublane tile, which the CUDA kernels do
    not need; the row-pair kernels read the padded count only for their
    group-sum rounding). The nibble layout goes to this module's kernel,
    u3 and pb to theirs in ``ops/rowpair_matmul.py`` (``:810-822``).
    ``plain`` runs the plain twin on any device (used to hold the kernel
    against it)."""
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
    if qt.layout in ROWPAIR_LAYOUTS:
        if plain:
            return rowpair_matmul_ref(x_perm, qt.layout, qt.planes,
                                      qt.opt_resid_scale, scale_vec, rows=m)
        if qt.layout == "u3":
            return rowpair_u3_matmul(x_perm, qt.planes, scale_vec, rows=m)
        return rowpair_pb_matmul(x_perm, qt.planes, qt.opt_resid_scale,
                                 scale_vec, rows=m)
    if plain:
        return fused_decode_matmul_ref(x_perm, qt.plane_list(),
                                       qt.decode_affine, scale_vec)[:m]
    return fused_decode_matmul(x_perm, qt.plane_list(), qt.decode_affine,
                               scale_vec, rows=m)


def grouped_permute(x: torch.Tensor, Gp: int) -> torch.Tensor:
    """(m, 8G) natural order -> (m, 8*Gp) grouped layout, pad lanes zero."""
    m, q_in = x.shape
    G = q_in // 8
    xp = x.reshape(m, G, 8).transpose(1, 2)                   # (m, 8, G)
    if Gp != G:
        xp = torch.nn.functional.pad(xp, (0, Gp - G))
    return xp.reshape(m, 8 * Gp)


def fused_quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                       plain: bool = False) -> torch.Tensor:
    """x (m, q_in) in natural K order -> (m, q_out)."""
    if x.shape[1] != qt.q_in:
        raise ValueError(f"x width {x.shape[1]} != q_in {qt.q_in}")
    return fused_quant_matmul_pre(grouped_permute(x, qt.group_cols), qt,
                                  plain=plain)
