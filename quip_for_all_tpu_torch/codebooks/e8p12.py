"""E8P12 2-bit lattice codebook: grids (numpy) and the record.

Counterpart of ``quip_for_all_tpu/codebooks/e8p12.py``: the same direct
(combinatorial) construction of the 256 abs patterns, the packed abs grid
and the full 2^16-entry decode table. An index c in [0, 2^16) decodes as:

    signs   = c & 0xFF            (8 sign bits)
    abs_idx = c >> 8              (which of the 256 abs patterns)
    parity  = popcount(signs) & 1
    signs  ^= parity              (flip LSB when parity is odd)
    w[i]    = sign_{bit 7-shuffle[i]}(signs) * abs[abs_idx, shuffle[i]]
              + (parity ? -0.25 : +0.25)

Rounding is ``codebooks/base.py`` ``nearest_codeword`` over the full grid.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache
from itertools import product

import numpy as np

from .base import Codebook

E8P_CODESZ = 8
_SHUFFLE = np.array([0, 2, 1, 3, 4, 6, 5, 7])

# 29 extra norm-12 abs patterns (values x2); their order defines indices
# 227..255 of the abs grid.
_NORM12_X2 = np.array([
    [3, 1, 1, 1, 3, 3, 3, 3],
    [1, 3, 1, 1, 3, 3, 3, 3],
    [1, 1, 3, 1, 3, 3, 3, 3],
    [1, 1, 1, 3, 3, 3, 3, 3],
    [3, 3, 3, 1, 3, 3, 1, 1],
    [3, 3, 3, 1, 3, 1, 3, 1],
    [3, 3, 3, 1, 1, 3, 3, 1],
    [3, 3, 3, 1, 3, 1, 1, 3],
    [3, 3, 3, 1, 1, 3, 1, 3],
    [3, 3, 3, 1, 1, 1, 3, 3],
    [3, 3, 1, 3, 3, 3, 1, 1],
    [3, 3, 1, 3, 3, 1, 3, 1],
    [3, 3, 1, 3, 1, 3, 3, 1],
    [3, 3, 1, 3, 3, 1, 1, 3],
    [3, 3, 1, 3, 1, 3, 1, 3],
    [3, 3, 1, 3, 1, 1, 3, 3],
    [3, 1, 3, 3, 3, 3, 1, 1],
    [3, 1, 3, 3, 3, 1, 3, 1],
    [3, 1, 3, 3, 1, 3, 3, 1],
    [3, 1, 3, 3, 3, 1, 1, 3],
    [3, 1, 3, 3, 1, 3, 1, 3],
    [1, 3, 3, 3, 1, 1, 3, 3],
    [1, 3, 3, 3, 3, 3, 1, 1],
    [1, 3, 3, 3, 3, 1, 3, 1],
    [1, 3, 3, 3, 1, 3, 3, 1],
    [1, 3, 3, 3, 3, 1, 1, 3],
    [1, 3, 3, 3, 1, 3, 1, 3],
    [1, 1, 3, 3, 1, 3, 3, 3],
    [3, 3, 1, 1, 3, 3, 3, 1],
], dtype=np.float64)


@lru_cache(maxsize=None)
def abs_grid_raw() -> np.ndarray:
    """The 256 abs patterns in canonical order, before shuffle/sign tricks.

    Rows 0..226: sorted {0.5,1.5,2.5}^8 patterns with norm^2 <= 10.
    Rows 227..255: the fixed norm-12 patterns.
    """
    pats = [p for p in product((0.5, 1.5, 2.5), repeat=8)
            if sum(v * v for v in p) <= 10.0]
    d8abs = np.array(sorted(pats), dtype=np.float64)
    assert d8abs.shape == (227, 8)
    return np.concatenate([d8abs, _NORM12_X2 / 2.0], axis=0)


@lru_cache(maxsize=None)
def abs_grid_bytes() -> np.ndarray:
    """(256, 8) int8: column-shuffled abs patterns x4, col 7 sign-flipped on
    odd row sum."""
    cba = abs_grid_raw()[:, _SHUFFLE].copy()
    row_sum = cba.sum(axis=1)  # integral for all rows
    cba[:, 7] *= 1.0 - 2.0 * (np.round(row_sum).astype(np.int64) % 2)
    return np.round(cba * 4.0).astype(np.int8)


@lru_cache(maxsize=None)
def packed_abs_grid() -> np.ndarray:
    """(256,) int64 packed abs grid (byte j = position j of the pattern)."""
    b = abs_grid_bytes().astype(np.int64) & 0xFF
    acc = b[:, 0]
    for i in range(1, 8):
        acc = acc | (b[:, i] << (8 * i))
    return acc


@lru_cache(maxsize=None)
def full_grid() -> np.ndarray:
    """(65536, 8) float32 — decode of every 16-bit index."""
    c = np.arange(1 << 16, dtype=np.int64)
    signs = c & 0xFF
    abs_idx = c >> 8
    p = signs ^ (signs >> 4)             # parity = popcount(signs) & 1
    p ^= p >> 2
    p ^= p >> 1
    parity = p & 1
    signs = signs ^ parity               # flips bit 0 when parity odd

    byts = abs_grid_bytes().astype(np.float32)
    out = np.empty((1 << 16, 8), dtype=np.float32)
    for i in range(8):
        ii = _SHUFFLE[i]
        v = byts[abs_idx, ii] / 4.0
        bit = (signs >> (7 - ii)) & 1
        out[:, i] = np.where(bit == 1, -v, v)
    out += np.where(parity == 1, -0.25, 0.25)[:, None].astype(np.float32)
    return out


@dataclasses.dataclass(frozen=True)
class E8P12(Codebook):
    id: str = "E8P12"
    codesz: int = E8P_CODESZ
    packsz: Fraction = Fraction(1)
    opt_resid_scale: float = -1.0
    opt_scale: float = 1.03
    idx_dtype: np.dtype = dataclasses.field(default=np.dtype(np.int16))

    def grid(self) -> np.ndarray:
        return full_grid()

    def pack_idxs(self, idxs: np.ndarray) -> np.ndarray:
        """Raw 0..65535 -> the int16 bit pattern checkpoints store."""
        return idxs.astype(np.uint16).view(np.int16)

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        return packed.view(np.uint16).astype(np.int32)
