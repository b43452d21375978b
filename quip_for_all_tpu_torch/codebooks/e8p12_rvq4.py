"""E8P RVQ 4-bit codebook: two cascaded 2-bit E8P lookups — counterpart of
``quip_for_all_tpu/codebooks/e8p12_rvq4.py`` minus ``quantize`` (the
quantization slice).

A raw code is (main16 << 16) | resid16 in one int32; it decodes as

    grid[main] + opt_resid_scale * grid[resid]

with ``grid`` the E8P12 full grid. Checkpoints store the raw int32 codes
as they are (packsz 1).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from .e8p12 import E8P_CODESZ, full_grid


@dataclasses.dataclass(frozen=True)
class E8P12RVQ4B:
    id: str = "E8P12RVQ4B"
    codesz: int = E8P_CODESZ
    packsz: Fraction = Fraction(1)
    opt_resid_scale: float = 1 / 3.45

    def grid(self) -> np.ndarray:
        return full_grid()

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
