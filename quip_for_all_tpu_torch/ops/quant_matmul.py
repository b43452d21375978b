"""quant_matmul: x @ W^T with W decoded on the fly from lattice codes —
counterpart of ``quip_for_all_tpu/ops/quant_matmul.py``.

  - "fused":   the layout's hand-written decode+matmul kernel
               (ops/fused_matmul.py dispatches), for m below the crossover.
  - "dequant": dense decode (ops/dequant.py), then one torch.matmul — the
               product the JAX package leaves to XLA outside any kernel.
  - "auto":    "fused" when m < max_m and the shape rule allows, else
               "dequant".
  - "plain":   the kernel's plain twin on any device; used only to hold
               the kernel against it.
"""
from __future__ import annotations

import torch

from .dequant import decode_weights
from .fused_matmul import fused_quant_matmul, supports
from .qtensor import QuantizedTensor

# Fused/dense crossover in rows of x. 1025 is the TPU v5e value the JAX
# package measured (ops/quant_matmul.py:22-35 there); it has not been
# re-measured on the H100 yet (ROADMAP.md queue 2).
FUSED_MAX_M = 1025

IMPLS = ("auto", "fused", "dequant", "plain")


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor, impl: str = "auto",
                 max_m: int = FUSED_MAX_M, ksplit: int = 0,
                 combine: int = 0) -> torch.Tensor:
    """x: (m, q_in) -> (m, q_out); ``ksplit`` asks the fused route for
    split-K and ``combine`` for the combined residual decode
    (``fused_quant_matmul_pre``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if x.shape[-1] != qt.q_in:
        raise ValueError(f"x width {x.shape[-1]} != q_in {qt.q_in}")
    if impl == "auto":
        impl = ("fused" if x.shape[0] < max_m and supports(qt)
                else "dequant")
    if impl in ("fused", "plain"):
        if not supports(qt):
            raise ValueError(f"fused route needs q_out % 128 == 0, got "
                             f"q_out={qt.q_out}")
        return fused_quant_matmul(x, qt, plain=impl == "plain",
                                  ksplit=ksplit, combine=combine)
    W = decode_weights(qt, dtype=x.dtype)
    return torch.matmul(x, W.T)
