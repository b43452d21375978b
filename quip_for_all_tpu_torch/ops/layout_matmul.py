"""The affine-nibble decode + matmul in the other nibble layouts and
schedule: wrappers of three hand-written CUDA kernels and their plain torch
twins.

  bfp_decode_matmul     K10, ``csrc/bfp_decode_matmul.cu``: bfp planes
                        (2, q_out/2, Gp), ``_make_kernel_bfp`` there;
  sw_decode_matmul      K11, ``csrc/sw_decode_matmul.cu``: sw2/sw4 subword
                        planes, ``_make_kernel(split=P)`` there;
  ksplit_decode_matmul  K6, ``csrc/ksplit_decode_matmul.cu``: nibble planes
                        with the group axis split into chunks,
                        ``_make_kernel_ksplit`` there.

All three compute K1's function (``ops/fused_matmul.py``):

    out(m, q_out) = sum_s alpha_s * (x_perm . nib_s) + beta_total * rowsum(x)

times scale_vec per output channel, cast to x's dtype, with x_perm in the
layout's grouped lane order: x_perm[:, i*Gp + g] = x[:, 8g + i] for bfp and
split-K, and x_perm[:, q*(P*Gp) + P*g + j] = x[:, 8g + (8/P)*j + q] for
sw{P}. Each twin follows its Pallas body's order of f32 operations (bfp:
the bf16 lane magic and the subtract of 128; sw: one field per subword
shift; split-K: per-chunk partials added in chunk order), so kernel and
twin differ only by f32 summation order: every product is exact.

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
the call raises. Each wrapper counts its launches (``.launches``, one per
call; split-K's call is a partial kernel and a reduce).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

SW_DTYPES = {torch.int16: 2, torch.int8: 4}


def pick_ksplit(requested: int, Gp: int) -> int:
    """Chunks of a split-K call: the largest divisor of Gp/128 that is <=
    ``requested`` (chunks stay 128-group aligned), 1 when none is > 1 or
    Gp is not a multiple of 128 (``_pick_ksplit`` in the JAX package)."""
    if requested <= 1 or Gp % 128 != 0:
        return 1
    nlanes = Gp // 128
    for d in range(min(requested, nlanes), 0, -1):
        if nlanes % d == 0:
            return d
    return 1


def _epilogue(out, affine, xf, scale_vec, dtype):
    out = out + float(sum(b for _, b in affine)) * xf.sum(dim=1,
                                                          keepdim=True)
    if scale_vec is not None:
        out = out * scale_vec.to(torch.float32)
    return out.to(dtype)


def bfp_decode_matmul_ref(x_perm: torch.Tensor,
                          planes: Sequence[torch.Tensor], affine,
                          scale_vec: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain twin of K10: per position 4*half + k the bf16 lane magic
    ((w >> 4k) & 0x000F000F) | 0x43004300 read as bf16 pairs (row 2t in
    the low half), minus 128, as the Pallas body does."""
    xf = x_perm.to(torch.float32)
    out = None
    for (alpha, _), w3 in zip(affine, planes):
        pairs, Gp = w3.shape[1], w3.shape[2]
        acc = None
        for half in (0, 1):
            for k in range(4):
                f = ((w3[half] >> (4 * k)) & 0x000F000F) | 0x43004300
                v = (f.contiguous().view(torch.bfloat16)
                     .reshape(pairs, Gp, 2).transpose(1, 2)
                     .reshape(2 * pairs, Gp).to(torch.float32) - 128.0)
                q = 4 * half + k
                d = xf[:, q * Gp:(q + 1) * Gp] @ v.T
                acc = d if acc is None else acc + d
        acc = acc * alpha
        out = acc if out is None else out + acc
    return _epilogue(out, affine, xf, scale_vec, x_perm.dtype)


def sw_decode_matmul_ref(x_perm: torch.Tensor,
                         planes: Sequence[torch.Tensor], affine,
                         scale_vec: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain twin of K11: field q of every subword at once against the x
    slice [q*P*Gp, (q+1)*P*Gp). torch's >> on int16/int8 is arithmetic, so
    every field is masked with 0xF, the last one too."""
    P = SW_DTYPES[planes[0].dtype]
    xf = x_perm.to(torch.float32)
    cols = planes[0].shape[1]                        # P*Gp
    out = None
    for (alpha, _), wb in zip(affine, planes):
        acc = None
        for q in range(8 // P):
            f = ((wb >> (4 * q)) & 0xF).to(torch.float32)
            d = xf[:, q * cols:(q + 1) * cols] @ f.T
            acc = d if acc is None else acc + d
        acc = acc * alpha
        out = acc if out is None else out + acc
    return _epilogue(out, affine, xf, scale_vec, x_perm.dtype)


def ksplit_decode_matmul_ref(x_perm: torch.Tensor,
                             planes: Sequence[torch.Tensor], affine,
                             chunks: int,
                             scale_vec: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain twin of K6: chunk k's partial sum_s alpha_s*(x_k . nib_s) +
    beta_total*rowsum(x_k) over groups [k*Gc, (k+1)*Gc), the partials
    added in chunk order, then the epilogue once."""
    m = x_perm.shape[0]
    q_out, Gp = planes[0].shape
    Gc = Gp // chunks
    x3 = x_perm.to(torch.float32).reshape(m, 8, Gp)
    beta_total = float(sum(b for _, b in affine))
    total = None
    for k in range(chunks):
        xk = x3[:, :, k * Gc:(k + 1) * Gc].reshape(m, 8 * Gc)
        part = None
        for (alpha, _), w in zip(affine, planes):
            wk = w[:, k * Gc:(k + 1) * Gc]
            nib = torch.stack([(wk >> (4 * i)) & 0xF for i in range(8)],
                              dim=1).reshape(q_out, 8 * Gc)
            acc = (xk @ nib.to(torch.float32).T) * alpha
            part = acc if part is None else part + acc
        part = part + beta_total * xk.sum(dim=1, keepdim=True)
        total = part if total is None else total + part
    if scale_vec is not None:
        total = total * scale_vec.to(torch.float32)
    return total.to(x_perm.dtype)


def check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp, dtype,
               shape):
    """The argument rules of the four nibble-math kernels (K1, K10, K11,
    K6): planes of ``dtype`` and ``shape``, x (rows..., 8*Gp)."""
    if x_perm.dim() != 2 or not x_perm.is_contiguous():
        raise ValueError("x_perm must be a contiguous 2-D tensor")
    if not 1 <= rows <= x_perm.shape[0]:
        raise ValueError(f"rows={rows} outside 1..{x_perm.shape[0]}")
    if x_perm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_perm dtype {x_perm.dtype} (want f32 or bf16)")
    if len(planes) not in (1, 2) or len(affine) != len(planes):
        raise ValueError("the kernel takes 1 or 2 plane sets, each with "
                         "its (alpha, beta)")
    if x_perm.shape[1] != 8 * Gp or Gp % 4 != 0:
        raise ValueError(f"x_perm width {x_perm.shape[1]} != 8*Gp={8 * Gp}"
                         " or Gp not a multiple of 4")
    for w in planes:
        if (w.dtype != dtype or tuple(w.shape) != shape
                or not w.is_contiguous() or w.device != x_perm.device):
            raise ValueError(f"planes must be contiguous {dtype} {shape} "
                             "tensors on x_perm's device")
    if scale_vec is not None and (
            scale_vec.dtype != torch.float32 or scale_vec.shape != (q_out,)
            or not scale_vec.is_contiguous()
            or scale_vec.device != x_perm.device):
        raise ValueError("scale_vec must be a contiguous f32 (q_out,) "
                         "tensor on x_perm's device")


def launch(kernel, entry, x_perm, planes, affine, scale_vec, rows, q_out,
           Gp, extra=(), ws=None):
    """One call of a nibble-math kernel's C entry point (csrc/<kernel>.cu)
    on the current stream; returns the (rows, q_out) output."""
    if x_perm.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_perm.device}")
    for t in [x_perm, *planes]:
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x and planes")
    from ._build import load
    fn = getattr(load(kernel), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (5 if ws is None else 6)
                       + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_int] * (1 + len(extra))
                       + [ctypes.c_void_p])
    out = torch.empty((rows, q_out), dtype=x_perm.dtype, device=x_perm.device)
    alphas = [float(a) for a, _ in affine] + [0.0]
    beta_total = float(sum(b for _, b in affine))
    stream = torch.cuda.current_stream(x_perm.device).cuda_stream
    ptrs = [x_perm.data_ptr(), planes[0].data_ptr(),
            planes[1].data_ptr() if len(planes) > 1 else None,
            scale_vec.data_ptr() if scale_vec is not None else None]
    if ws is not None:
        ptrs.append(ws.data_ptr())
    err = fn(*ptrs, out.data_ptr(), rows, q_out, Gp, len(planes), alphas[0],
             alphas[1], beta_total, int(x_perm.dtype == torch.bfloat16),
             *extra, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    return out


def bfp_decode_matmul(x_perm: torch.Tensor, planes: Sequence[torch.Tensor],
                      affine, scale_vec: Optional[torch.Tensor] = None,
                      rows: Optional[int] = None) -> torch.Tensor:
    """K10 wrapper: (rows, q_out) from the first ``rows`` rows of x_perm
    (default all; the rest may be padding that is never read); planes are
    1 or 2 bfp planes (2, q_out/2, Gp) int32."""
    rows = x_perm.shape[0] if rows is None else rows
    _, pairs, Gp = planes[0].shape
    q_out = 2 * pairs
    check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp, torch.int32,
           (2, pairs, Gp))
    if x_perm.device.type == "cpu":
        return bfp_decode_matmul_ref(x_perm[:rows], planes, affine, scale_vec)
    out = launch("bfp_decode_matmul", "qfa_bfp_decode_matmul", x_perm,
                  planes, affine, scale_vec, rows, q_out, Gp)
    bfp_decode_matmul.launches += 1
    return out


def sw_decode_matmul(x_perm: torch.Tensor, planes: Sequence[torch.Tensor],
                     affine, scale_vec: Optional[torch.Tensor] = None,
                     rows: Optional[int] = None) -> torch.Tensor:
    """K11 wrapper: planes are 1 or 2 subword planes (q_out, P*Gp), int16
    (sw2) or int8 (sw4); x_perm in the sw{P} lane order."""
    rows = x_perm.shape[0] if rows is None else rows
    if planes[0].dtype not in SW_DTYPES:
        raise ValueError(f"sw planes are int16 or int8, not "
                         f"{planes[0].dtype}")
    P = SW_DTYPES[planes[0].dtype]
    q_out, cols = planes[0].shape
    Gp = cols // P
    check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp,
           planes[0].dtype, (q_out, P * Gp))
    if x_perm.device.type == "cpu":
        return sw_decode_matmul_ref(x_perm[:rows], planes, affine, scale_vec)
    out = launch("sw_decode_matmul", "qfa_sw_decode_matmul", x_perm, planes,
                  affine, scale_vec, rows, q_out, Gp, extra=(P,))
    sw_decode_matmul.launches += 1
    return out


def ksplit_decode_matmul(x_perm: torch.Tensor,
                         planes: Sequence[torch.Tensor], affine, chunks: int,
                         scale_vec: Optional[torch.Tensor] = None,
                         rows: Optional[int] = None) -> torch.Tensor:
    """K6 wrapper: nibble planes (q_out, Gp) int32 with the group axis in
    ``chunks`` >= 2 chunks of a multiple of 16 groups (the kernel's whole
    slabs; every ``pick_ksplit`` chunk is a multiple of 128); the f32
    partials (chunks, rows, q_out) come from the caching allocator (the
    kernel leaves them unused where it runs K1's body over whole tiles)."""
    rows = x_perm.shape[0] if rows is None else rows
    q_out, Gp = planes[0].shape
    check_call(x_perm, planes, affine, scale_vec, rows, q_out, Gp, torch.int32,
           (q_out, Gp))
    if chunks < 2 or Gp % chunks or (Gp // chunks) % 16:
        raise ValueError(f"{chunks} chunks do not split Gp={Gp} into "
                         "multiples of 16 groups")
    if x_perm.device.type == "cpu":
        return ksplit_decode_matmul_ref(x_perm[:rows], planes, affine,
                                        chunks, scale_vec)
    ws = torch.empty((chunks, rows, q_out), dtype=torch.float32,
                     device=x_perm.device)
    out = launch("ksplit_decode_matmul", "qfa_ksplit_decode_matmul", x_perm,
                  planes, affine, scale_vec, rows, q_out, Gp,
                  extra=(chunks,), ws=ws)
    ksplit_decode_matmul.launches += 1
    return out


bfp_decode_matmul.launches = 0
sw_decode_matmul.launches = 0
ksplit_decode_matmul.launches = 0
