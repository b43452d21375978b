"""Expert-indexed fused decode + matmul: the wrapper of the hand-written
CUDA kernel ``csrc/moe_decode_matmul.cu`` and its plain torch twin.

Counterpart of ``quip_for_all_tpu/ops/moe_pallas.py``. One kernel ports
both Pallas bodies: ``_make_moe_kernel`` (K4, either grid order) and
``_make_moe_kernel_merged`` (K5, ``QFA_MOE_MERGED``); all three compute the
same function. Row r uses the planes of expert ``eids[r]``:

    out[r, n] = sum_s alpha_s * (x_perm[r] @ nib_s(planes_s[eids[r]])^T)[n]
                + beta_total * rowsum(x_perm[r])

in f32, cast to x_perm's dtype. There is no scale epilogue: the
per-expert ``pre_vec`` applies after the cast (``nn/qmoe.py``). x_perm is
in the grouped layout x_perm[:, i*Gp + g] = x[:, 8g + i] (pad lanes zero),
each row already in its expert's incoherence basis. Only the selected
experts' planes are read, once per distinct expert (and chunk of up to 8
of its rows) on K1's tensor-core body (``csrc/nibble_mma_small.cuh``). The JAX schedule knobs
(``QFA_MOE_TILES_INNER``, ``QFA_MAGIC_MOE``, ``QFA_MOE_TN``) and the row
sort in ``stacked_rows_apply`` change no result and have no counterpart.

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
the call raises. The wrapper never reads ``eids`` back to the host, so a
decode step does not synchronise and can be captured in a CUDA graph.

The kernel has no backward, as the JAX package's Pallas MoE call has no
VJP (``jax.grad`` through it raises ``NotImplementedError``):
``moe_fused_matmul`` raises the same error, on every device, when autograd
would need a gradient of x_perm, rather than return a result cut from the
graph. The plain twin ``moe_fused_matmul_ref`` (``matmul_impl="plain"``
in ``nn/qmoe.py``) stays differentiable, as the JAX package's XLA route
is. Decode runs under ``torch.no_grad()`` and never meets the raise.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .fused_matmul import fused_decode_matmul_ref

KERNEL = "moe_decode_matmul"
MAX_EXPERTS = 64      # the kernel keeps the experts present as a 64-bit mask


def moe_fused_matmul_ref(x_perm: torch.Tensor, eids: torch.Tensor,
                         planes: Sequence[torch.Tensor], affine
                         ) -> torch.Tensor:
    """Plain twin of the kernel: the same math in torch ops, decoded per
    distinct expert (a per-row decode, as the JAX package's XLA fallback
    ``_decode_rows_matmul`` does, would hold R copies of the planes in
    f32). Reads the expert ids back to the host."""
    out = torch.empty((x_perm.shape[0], planes[0].shape[1]),
                      dtype=x_perm.dtype, device=x_perm.device)
    for e in torch.unique(eids).tolist():
        rows = (eids == e).nonzero(as_tuple=True)[0]
        out[rows] = fused_decode_matmul_ref(x_perm[rows],
                                            [p[e] for p in planes], affine)
    return out


def _check(x_perm, eids, planes, affine, rows_per_expert):
    if x_perm.dim() != 2 or not x_perm.is_contiguous():
        raise ValueError("x_perm must be a contiguous 2-D tensor")
    if x_perm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_perm dtype {x_perm.dtype} (want f32 or bf16)")
    R = x_perm.shape[0]
    if (eids.dtype != torch.int32 or eids.shape != (R,)
            or not eids.is_contiguous() or eids.device != x_perm.device):
        raise ValueError("eids must be a contiguous int32 (R,) tensor on "
                         "x_perm's device")
    if rows_per_expert < 1:
        raise ValueError(f"rows_per_expert={rows_per_expert} (want >= 1)")
    if len(planes) not in (1, 2) or len(affine) != len(planes):
        raise ValueError("the kernel takes 1 or 2 plane sets, each with "
                         "its (alpha, beta)")
    if planes[0].dim() != 3:
        raise ValueError("planes must be stacked (E, q_out, Gp)")
    E, q_out, Gp = planes[0].shape
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts (the kernel takes 1..{MAX_EXPERTS})")
    if x_perm.shape[1] != 8 * Gp or Gp % 4 != 0:
        raise ValueError(f"x_perm width {x_perm.shape[1]} != 8*Gp={8 * Gp}"
                         " or Gp not a multiple of 4")
    for w in planes:
        if (w.dtype != torch.int32 or w.shape != (E, q_out, Gp)
                or not w.is_contiguous() or w.device != x_perm.device):
            raise ValueError("planes must be contiguous int32 (E, q_out, Gp)"
                             " tensors on x_perm's device")


def moe_fused_matmul(x_perm: torch.Tensor, eids: torch.Tensor,
                     planes: Sequence[torch.Tensor], affine,
                     rows_per_expert: int) -> torch.Tensor:
    """Kernel wrapper: x_perm (R, 8*Gp), R >= 1, eids (R,) int32 in
    0..E-1, 1 or 2 stacked plane sets (E, q_out, Gp) int32 -> (R, q_out) in
    x_perm's dtype; q_out takes any value. ``rows_per_expert`` bounds how
    many rows any one expert has (top-K routing of m tokens gives at most
    m; R bounds any routing); the kernel checks it and takes an expert's
    rows in chunks of 8 whatever it says, so the result does not depend
    on it. Raises
    ``NotImplementedError`` when gradients are on and x_perm requires grad.
    ``moe_fused_matmul.launches`` counts kernel launches (plain-twin calls
    on CPU tensors are not counted). The ids stay on the device: one
    outside 0..E-1 leaves its row unwritten on a card."""
    if torch.is_grad_enabled() and x_perm.requires_grad:
        raise NotImplementedError(
            "moe_fused_matmul has no backward (neither has the JAX package's "
            "Pallas MoE call); take the differentiable plain route, "
            "matmul_impl='plain' (moe_fused_matmul_ref), or run under "
            "torch.no_grad()")
    _check(x_perm, eids, planes, affine, rows_per_expert)
    if x_perm.device.type == "cpu":
        return moe_fused_matmul_ref(x_perm, eids, planes, affine)
    if x_perm.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x_perm.device}")
    for t in [x_perm, *planes]:
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x and planes")
    from ._build import load
    lib = load(KERNEL)
    fn = lib.qfa_moe_decode_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
    E, q_out, Gp = planes[0].shape
    R = x_perm.shape[0]
    max_rows = min(R, rows_per_expert)
    out = torch.empty((R, q_out), dtype=x_perm.dtype, device=x_perm.device)
    alphas = [float(a) for a, _ in affine] + [0.0]
    beta_total = float(sum(b for _, b in affine))
    stream = torch.cuda.current_stream(x_perm.device).cuda_stream
    err = fn(x_perm.data_ptr(), eids.data_ptr(), planes[0].data_ptr(),
             planes[1].data_ptr() if len(planes) > 1 else None,
             out.data_ptr(), R, max_rows, E, q_out, Gp, len(planes),
             alphas[0], alphas[1], beta_total,
             int(x_perm.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    moe_fused_matmul.launches += 1
    return out


moe_fused_matmul.launches = 0
