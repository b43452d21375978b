"""Fused u-code decode + matmul: the wrappers of the hand-written CUDA
kernels of ``csrc/rowpair_decode_matmul.cu`` (row-pair u3 and pb) and
``csrc/paired_decode_matmul.cu`` (paired), and their plain torch twin.

Counterpart of ``quip_for_all_tpu/ops/dequant_pallas.py``
``_make_kernel_u3`` (u3 layout, E8P12), ``_make_kernel_pb`` (pb layout,
E8P12RVQ4B) and ``_make_kernel_paired`` (paired layout, E8P12RVQ4B)
through both ``_fused_call`` grids. For x in the grouped layout
x_perm[:, i*Gp + g] = x[:, 8g + i] (pad lanes zero):

  u3:  out = sum_i x_i . u_i - 0.5 * (gx . par) - 2.25 * rowsum(x)
  pb, paired (the same function on two packings):
       out = (d0 + rs*d1) - 0.5 * (gx . p0 + rs * (gx . p1))
             - 2.25 * (1 + rs) * rowsum(x)
       d0 = sum_i x_i . u0_i,  d1 = sum_i x_i . u1_i

with gx[:, g] = sum_{i=0..7} x_perm[:, i*Gp + g] (the group sums), then
times scale_vec per output channel and a cast to x's dtype, and with
``right_hb`` the right epilogue (``ops/layout_matmul.py``
``right_epilogue``; ``_epilogue`` ``:459-472`` there).

The group sum's rounding follows the Pallas body: a block of at most 8 rows
of x runs in f32, a larger bf16 block keeps x in bf16 and sums gx in bf16,
left to right over i. The block is ``_fused_call``'s m-tile of the padded
row count, so the rule reads x_perm's row count (``group_sum_in_bf16``).
Every product is exact in f32 at bf16 x (u <= 7, parities 0/1); the
kernel and its twin differ only by f32 summation order.

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or the
call raises. ``rowpair_u3_matmul.launches``, ``rowpair_pb_matmul.launches``
and ``paired_decode_matmul.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .layout_matmul import check_right, right_epilogue
from .qtensor import (paired_uv_from_planes, pb_uv_from_planes,
                      u3_up_from_planes)

KERNEL = "rowpair_decode_matmul"
PAIRED_KERNEL = "paired_decode_matmul"


def pallas_block_rows(mp: int) -> int:
    """Rows of x per Pallas block for a padded row count mp (a multiple of
    8): ``_fused_call``'s TM (``dequant_pallas.py:852-855``)."""
    tm = min(mp, 32)
    while mp % tm:
        tm //= 2
    return tm


def group_sum_in_bf16(x_perm: torch.Tensor) -> bool:
    """Whether the Pallas body sums the groups of this x in bf16: bf16 x in
    blocks of more than QFA_F32_SMALL_M = 8 rows (``:516-517``,
    ``:589-590``)."""
    return (x_perm.dtype == torch.bfloat16
            and pallas_block_rows(x_perm.shape[0]) > 8)


def _group_sums(x_perm: torch.Tensor, Gp: int) -> torch.Tensor:
    """gx (m, Gp), summed left to right over the 8 positions in bf16 or in
    f32 as the Pallas body does (``:553-555``, ``:616-618``)."""
    x = x_perm if group_sum_in_bf16(x_perm) else x_perm.to(torch.float32)
    gx = x[:, :Gp]
    for i in range(1, 8):
        gx = gx + x[:, i * Gp:(i + 1) * Gp]
    return gx.to(torch.float32)


def _lanes(u: torch.Tensor) -> torch.Tensor:
    """(q_out, Gp, 8) per-position codes -> (q_out, 8*Gp) f32 in x_perm's
    lane order."""
    return u.transpose(1, 2).reshape(u.shape[0], -1).to(torch.float32)


def rowpair_matmul_ref(x_perm: torch.Tensor, layout: str,
                       planes: Dict[str, torch.Tensor], rs: float = -1.0,
                       scale_vec: Optional[torch.Tensor] = None,
                       rows: Optional[int] = None,
                       right_hb: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain twin of the three kernels: (rows, q_out) in x_perm's dtype, in
    the Pallas bodies' order of f32 operations. x_perm may carry pad rows
    past ``rows`` (they set the group sum's rounding, never the result)."""
    rows = x_perm.shape[0] if rows is None else rows
    Gp = planes["w0"].shape[-1]
    gx = _group_sums(x_perm, Gp)[:rows]
    x_perm = x_perm[:rows]
    xf = x_perm.to(torch.float32)
    xs = xf.sum(dim=1, keepdim=True)
    if layout == "u3":
        u, par = u3_up_from_planes(planes)
        out = xf @ _lanes(u).T
        out = out - 0.5 * (gx @ par.to(torch.float32).T) - 2.25 * xs
    elif layout in ("pb", "paired"):
        u0, p0, u1, p1 = (pb_uv_from_planes if layout == "pb"
                          else paired_uv_from_planes)(planes)
        out = xf @ _lanes(u0).T + rs * (xf @ _lanes(u1).T)
        out = (out - 0.5 * (gx @ p0.to(torch.float32).T
                            + rs * (gx @ p1.to(torch.float32).T))
               - 2.25 * (1.0 + rs) * xs)
    else:
        raise ValueError(f"no u-code kernel for layout {layout!r}")
    if scale_vec is not None:
        out = out * scale_vec.to(torch.float32)
    return right_epilogue(out.to(x_perm.dtype), right_hb)


def _check(x_perm, layout, planes, scale_vec, rows, right_hb):
    if x_perm.dim() != 2 or not x_perm.is_contiguous():
        raise ValueError("x_perm must be a contiguous 2-D tensor")
    if not 1 <= rows <= x_perm.shape[0]:
        raise ValueError(f"rows={rows} outside 1..{x_perm.shape[0]}")
    if x_perm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_perm dtype {x_perm.dtype} (want f32 or bf16)")
    if sorted(planes) != ["w0", "w1", "w2"]:
        raise ValueError(f"{layout} planes are w0, w1, w2, not "
                         f"{sorted(planes)}")
    w0, w1, w2 = planes["w0"], planes["w1"], planes["w2"]
    Gp, PL = w0.shape[-1], w2.shape[-1]
    half = w2.shape[0]
    q_out = half if layout == "paired" else 2 * half
    if layout in ("u3", "paired"):     # paired: one row per word, PL = Wp
        want = {"w0": (half, Gp), "w1": (half, Gp // 2), "w2": (half, PL)}
        # 4 groups of a lane share one half of w1 and one parity field
        ok = Gp % 8 == 0 and PL % 4 == 0 and Gp % PL == 0 and Gp // PL <= 16
    else:
        want = {"w0": (2, half, Gp), "w1": (half, Gp), "w2": (half, PL)}
        ok = Gp % 4 == 0 and PL % 4 == 0 and -(-Gp // PL) <= 8
    if not ok or any(tuple(planes[k].shape) != s for k, s in want.items()):
        raise ValueError(f"{layout} plane shapes "
                         f"{[tuple(planes[k].shape) for k in want]} do not "
                         f"form the layout (want {list(want.values())})")
    if x_perm.shape[1] != 8 * Gp:
        raise ValueError(f"x_perm width {x_perm.shape[1]} != 8*Gp={8 * Gp}")
    for w in (w0, w1, w2):
        if (w.dtype != torch.int32 or not w.is_contiguous()
                or w.device != x_perm.device):
            raise ValueError("planes must be contiguous int32 tensors on "
                             "x_perm's device")
    if scale_vec is not None and (
            scale_vec.dtype != torch.float32
            or scale_vec.shape != (q_out,)
            or not scale_vec.is_contiguous()
            or scale_vec.device != x_perm.device):
        raise ValueError("scale_vec must be a contiguous f32 (q_out,) "
                         "tensor on x_perm's device")
    check_right(right_hb, q_out, x_perm.device)


def _launch(fn_name, x_perm, layout, planes, rs, scale_vec, rows,
            right_hb=None):
    from ._build import load
    for t in (x_perm, *planes.values()):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x and planes")
    kernel = PAIRED_KERNEL if layout == "paired" else KERNEL
    fn = getattr(load(kernel), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    w0, w1, w2 = planes["w0"], planes["w1"], planes["w2"]
    q_out = w2.shape[0] * (1 if layout == "paired" else 2)
    Gp, PL = w0.shape[-1], w2.shape[-1]
    out = torch.empty((rows, q_out), dtype=x_perm.dtype, device=x_perm.device)
    beta = 2.25 if layout == "u3" else 2.25 * (1.0 + rs)
    stream = torch.cuda.current_stream(x_perm.device).cuda_stream
    err = fn(x_perm.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
             scale_vec.data_ptr() if scale_vec is not None else None,
             right_hb.data_ptr() if right_hb is not None else None,
             out.data_ptr(), rows, q_out, Gp, PL, float(rs), beta,
             int(group_sum_in_bf16(x_perm)),
             int(x_perm.dtype == torch.bfloat16),
             0 if right_hb is None else right_hb.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"{kernel} ({layout}) launch failed: cudaError "
                           f"{err}")
    return out


def _rowpair(layout, x_perm, planes, rs, scale_vec, rows, right_hb):
    rows = x_perm.shape[0] if rows is None else rows
    _check(x_perm, layout, planes, scale_vec, rows, right_hb)
    if x_perm.device.type == "cpu":
        return rowpair_matmul_ref(x_perm, layout, planes, rs, scale_vec,
                                  rows, right_hb)
    if x_perm.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_perm.device}")
    entry = ("qfa_paired_decode_matmul_ex" if layout == "paired"
             else f"qfa_rowpair_{layout}_matmul_ex")
    return _launch(entry, x_perm, layout, planes, rs, scale_vec, rows,
                   right_hb)


def rowpair_u3_matmul(x_perm: torch.Tensor, planes: Dict[str, torch.Tensor],
                      scale_vec: Optional[torch.Tensor] = None,
                      rows: Optional[int] = None,
                      right_hb: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The u3 kernel (K9): (rows, q_out) from the first ``rows`` rows of
    x_perm (default all; the rest may be padding that is never read);
    ``right_hb`` runs the right epilogue in the kernel."""
    out = _rowpair("u3", x_perm, planes, -1.0, scale_vec, rows, right_hb)
    if x_perm.device.type == "cuda":
        rowpair_u3_matmul.launches += 1
    return out


def rowpair_pb_matmul(x_perm: torch.Tensor, planes: Dict[str, torch.Tensor],
                      rs: float, scale_vec: Optional[torch.Tensor] = None,
                      rows: Optional[int] = None,
                      right_hb: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The pb kernel (K8), as ``rowpair_u3_matmul`` with the residual scale
    ``rs``."""
    out = _rowpair("pb", x_perm, planes, rs, scale_vec, rows, right_hb)
    if x_perm.device.type == "cuda":
        rowpair_pb_matmul.launches += 1
    return out


def paired_decode_matmul(x_perm: torch.Tensor,
                         planes: Dict[str, torch.Tensor], rs: float,
                         scale_vec: Optional[torch.Tensor] = None,
                         rows: Optional[int] = None,
                         right_hb: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The paired kernel (K7), as ``rowpair_pb_matmul`` on the paired
    planes w0 (q_out, Gp), w1 (q_out, Gp/2), w2 (q_out, Wp)."""
    out = _rowpair("paired", x_perm, planes, rs, scale_vec, rows, right_hb)
    if x_perm.device.type == "cuda":
        paired_decode_matmul.launches += 1
    return out


rowpair_u3_matmul.launches = 0
rowpair_pb_matmul.launches = 0
paired_decode_matmul.launches = 0
