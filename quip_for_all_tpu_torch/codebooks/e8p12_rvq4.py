"""E8P RVQ 4-bit codebook: two cascaded 2-bit E8P lookups — counterpart of
``quip_for_all_tpu/codebooks/e8p12_rvq4.py``.

A raw code is (main16 << 16) | resid16 in one int32; it decodes as

    grid[main] + opt_resid_scale * grid[resid]

with ``grid`` the E8P12 full grid. Checkpoints store the raw int32 codes
as they are (packsz 1). Rounding takes the main code, then rounds the
residual over the same grid at ``opt_resid_scale``.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from .base import Codebook, grid_tensors, nearest_codeword
from .e8p12 import E8P_CODESZ, full_grid


def as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 with their low 32 bits (what an int32
    shift-and-add that wraps gives)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class E8P12RVQ4B(Codebook):
    id: str = "E8P12RVQ4B"
    codesz: int = E8P_CODESZ
    packsz: Fraction = Fraction(1)
    opt_resid_scale: float = 1 / 3.45
    opt_scale: float = 1.03
    idx_dtype: np.dtype = dataclasses.field(default=np.dtype(np.int32))

    def grid(self) -> np.ndarray:
        return full_grid()

    def quantize(self, X: torch.Tensor, chunk: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, codes): main << 16 plus the residual's code, with the
        int32 wrap of the JAX package's shift (main >= 2^15 gives a
        negative code)."""
        g, gn = grid_tensors(full_grid, X.device, X.dtype)
        main_vals, main_idx = nearest_codeword(X, g, gn, chunk)
        resid = (X - main_vals) / self.opt_resid_scale
        r_vals, r_idx = nearest_codeword(resid, g, gn, chunk)
        vals = main_vals + r_vals * self.opt_resid_scale
        idx = (main_idx.to(torch.int64) << 16) + r_idx.to(torch.int64)
        return vals, as_int32_bits(idx)

    def decode(self, idxs: torch.Tensor, dtype=torch.float32
               ) -> torch.Tensor:
        """(q_out, G) int32 raw codes -> (q_out, 8G) weights."""
        u = idxs.to(torch.int64) & 0xFFFFFFFF
        g = torch.as_tensor(full_grid(), device=idxs.device).to(dtype)
        w = g[u >> 16] + self.opt_resid_scale * g[u & 0xFFFF]
        return w.reshape(idxs.shape[0], -1)

    def pack_idxs(self, idxs: np.ndarray) -> np.ndarray:
        return idxs.astype(np.uint32).view(np.int32)

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        return packed.view(np.int32)
