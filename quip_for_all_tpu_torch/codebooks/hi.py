"""HI 4-bit codebook: the scalar half-integer grid {-7.5, ..., 7.5}, one
weight a code — counterpart of ``quip_for_all_tpu/codebooks/hi.py``.
Checkpoints pack eight 4-bit codes into one int32 in the order 0, 2, 4, 6,
1, 3, 5, 7 of the 8 columns (packsz 8); the runtime planes hold the code
itself as the nibble (weight = nib - 7.5).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache

import numpy as np

from .base import Codebook

_NIBBLE_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


@lru_cache(maxsize=None)
def hi_grid() -> np.ndarray:
    """(16, 1) float32 grid, code order."""
    return (np.arange(-8, 8, dtype=np.float32) + 0.5)[:, None]


@dataclasses.dataclass(frozen=True)
class HI4B1C(Codebook):
    id: str = "HI"
    codesz: int = 1
    packsz: Fraction = Fraction(8)
    opt_resid_scale: float = -1.0
    opt_scale: float = 2.97
    idx_dtype: np.dtype = dataclasses.field(default=np.dtype(np.int32))

    def grid(self) -> np.ndarray:
        return hi_grid()

    def pack_idxs(self, idxs: np.ndarray) -> np.ndarray:
        m, n = idxs.shape
        if n % 8:
            raise ValueError(f"HI packs 8 codes a word: {n} columns")
        idxs = idxs.astype(np.int64)
        acc = np.zeros((m, n // 8), dtype=np.int64)
        for nibble, col in enumerate(_NIBBLE_ORDER):
            acc |= (idxs[:, col::8] & 0xF) << (4 * nibble)
        return acc.astype(np.uint32).view(np.int32)

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        m, n8 = packed.shape
        p = np.ascontiguousarray(packed).view(np.uint32).astype(np.int64)
        out = np.zeros((m, n8 * 8), dtype=np.int32)
        for nibble, col in enumerate(_NIBBLE_ORDER):
            out[:, col::8] = ((p >> (4 * nibble)) & 0xF).astype(np.int32)
        return out
