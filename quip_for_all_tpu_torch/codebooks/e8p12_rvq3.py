"""E8P RVQ 3-bit codebook: a 2-bit E8P main stage and a 1-bit E8 residual
stage ("E81B") — counterpart of ``quip_for_all_tpu/codebooks/e8p12_rvq3.py``,
in numpy and torch.

The residual grid has 256 entries: the E8 lattice points of norm^2 <= 2
(the zero vector, every +-e_i +- e_j with i < j, every +-1/2 vector with
an even number of minus signs), then 15 of the 16 +-2e_i (-2e_7 left out).
Sorting each part lexicographically ascending reproduces the reference's
occurrence order. A raw code is (main16 << 8) | resid8 (24 bits); it
decodes as grid[main] + opt_resid_scale * e81b[resid]. Checkpoints pack 4
codes into 3 int32 by dropping each code's unused high byte
(little-endian, packsz 4/3).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache
from itertools import combinations, product
from typing import Optional, Tuple

import numpy as np
import torch

from .base import Codebook, grid_tensors, nearest_codeword
from .e8p12 import E8P_CODESZ, full_grid

_NIBBLE_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


@lru_cache(maxsize=None)
def e81b_grid() -> np.ndarray:
    """(256, 8) float32 residual grid, reference order."""
    ints = [np.zeros(8)]
    for i, j in combinations(range(8), 2):
        for si, sj in product((1, -1), repeat=2):
            v = np.zeros(8)
            v[i], v[j] = si, sj
            ints.append(v)
    ints = np.array(sorted(map(tuple, ints)), dtype=np.float64)
    halfs = np.array(sorted(s for s in product((0.5, -0.5), repeat=8)
                            if s.count(-0.5) % 2 == 0), dtype=np.float64)
    norm4 = np.concatenate([2 * np.eye(8), -2 * np.eye(8)[:7]], axis=0)
    return np.concatenate([ints, halfs, norm4], axis=0).astype(np.float32)


@lru_cache(maxsize=None)
def e81b_grid_packed() -> np.ndarray:
    """(256,) int32 nibble-packed residual grid (values x2, columns in the
    order 0, 2, 4, 6, 1, 3, 5, 7, 4-bit two's complement), the reference's
    kernel table."""
    g = e81b_grid().astype(np.float64)[:, list(_NIBBLE_ORDER)]
    gi = np.round(g * 2).astype(np.int64) & 0xF
    acc = gi[:, 0]
    for i in range(1, 8):
        acc |= gi[:, i] << (4 * i)
    return acc.astype(np.uint32).view(np.int32)


@dataclasses.dataclass(frozen=True)
class E8P12RVQ3B(Codebook):
    id: str = "E8P12RVQ3B"
    codesz: int = E8P_CODESZ
    packsz: Fraction = Fraction(4, 3)
    opt_resid_scale: float = 1 / 2.04
    opt_scale: float = 0.98
    idx_dtype: np.dtype = dataclasses.field(default=np.dtype(np.int32))

    def grid(self) -> np.ndarray:
        return full_grid()

    def resid_grid(self) -> np.ndarray:
        return e81b_grid()

    def quantize(self, X: torch.Tensor, chunk: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, codes): the main code << 8 plus the residual's code
        over the E81B grid at ``opt_resid_scale``."""
        g, gn = grid_tensors(full_grid, X.device, X.dtype)
        main_vals, main_idx = nearest_codeword(X, g, gn, chunk)
        rg, rgn = grid_tensors(e81b_grid, X.device, X.dtype)
        resid = (X - main_vals) / self.opt_resid_scale
        r_vals, r_idx = nearest_codeword(resid, rg, rgn, chunk)
        vals = main_vals + r_vals * self.opt_resid_scale
        return vals, (main_idx << 8) + r_idx

    def decode(self, idxs: torch.Tensor, dtype=torch.float32
               ) -> torch.Tensor:
        """(q_out, G) int32 raw codes -> (q_out, 8G) weights."""
        g = torch.as_tensor(full_grid(), device=idxs.device).to(dtype)
        rg = torch.as_tensor(e81b_grid(), device=idxs.device).to(dtype)
        i = idxs.to(torch.int64)
        w = g[i >> 8] + self.opt_resid_scale * rg[i & 0xFF]
        return w.reshape(idxs.shape[0], -1)

    def pack_idxs(self, idxs: np.ndarray) -> np.ndarray:
        m, n = idxs.shape
        if n % 4:
            raise ValueError(f"RVQ3 packs 4 codes in 3 words: {n} columns")
        b = np.ascontiguousarray(idxs.astype("<i4")).view(np.uint8)
        b = b.reshape(m, n, 4)[:, :, :3]
        return np.ascontiguousarray(b).reshape(m, -1).view("<i4")

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        m = packed.shape[0]
        b = np.ascontiguousarray(packed.astype("<i4")).view(np.uint8)
        b = b.reshape(m, -1, 3)
        out = np.zeros((m, b.shape[1], 4), dtype=np.uint8)
        out[:, :, :3] = b
        return np.ascontiguousarray(out.reshape(m, -1)).view(
            "<i4").astype(np.int32)
