"""D4 2-bit codebook: the deep-hole-centered D4 lattice, 256 half-integer
4-vectors with even component sum and norm^2 <= 9 — counterpart of
``quip_for_all_tpu/codebooks/d4.py``. The enumeration order is the on-disk
code space, so the map from index to codeword is the JAX package's (and its
reference's) own:

  index i = i3 << 5 | i8, i8 in [0, 32) picks the magnitudes
    0          -> [.5 .5 .5 .5]
    1          -> [1.5 1.5 1.5 1.5]
    2..7       -> ibx = i8 >> 1 in {1, 2, 3}; odd i8: base .5 with
                  positions 0 and ibx at 1.5; even i8: base 1.5 with
                  positions 0 and ibx at .5
    8..11      -> base .5, position i8 & 3 at 1.5
    12..15     -> base 1.5, position i8 & 3 at .5
    16..19     -> base .5, position i8 & 3 at 2.5
    20..31     -> base .5, position ib4 = (i8 - 20) & 3 at 1.5, position
                  ib3 (skipping ib4) at 2.5
  and i3 the signs: bit 5 negates x[2], bit 6 negates x[1], then x[3] is
  negated iff the sum is odd (even parity), bit 7 negates all.

Checkpoints store one uint8 index per 4 weights (packsz 1). Each weight is
a half-integer in [-2.5, 2.5]; the runtime planes hold nib = 2*w + 8
(``ops/qtensor.py``).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache

import numpy as np

from .base import Codebook

D4_CODESZ = 4


def _magnitudes(i8: int) -> list:
    if i8 == 0:
        return [0.5] * 4
    if i8 == 1:
        return [1.5] * 4
    if i8 < 8:
        ibx = i8 >> 1
        x = [0.5] * 4 if i8 & 1 else [1.5] * 4
        v = 1.5 if i8 & 1 else 0.5
        x[0] = v
        x[ibx] = v
        return x
    if i8 < 20:
        base, v = {0: (0.5, 1.5), 1: (1.5, 0.5), 2: (0.5, 2.5)}[
            (i8 - 8) >> 2]
        x = [base] * 4
        x[i8 & 3] = v
        return x
    ibx = i8 - 20
    ib4, ib3 = ibx & 3, ibx >> 2
    x = [0.5] * 4
    x[ib4] = 1.5
    x[ib3 + (ib3 >= ib4)] = 2.5
    return x


@lru_cache(maxsize=None)
def d4_grid() -> np.ndarray:
    """(256, 4) float32 codebook, index order."""
    cb = np.zeros((256, D4_CODESZ), dtype=np.float64)
    for i in range(256):
        x = _magnitudes(i & 31)
        if i & (1 << 5):
            x[2] = -x[2]
        if i & (1 << 6):
            x[1] = -x[1]
        if round(sum(x)) % 2 != 0:
            x[3] = -x[3]
        if i & (1 << 7):
            x = [-v for v in x]
        cb[i] = x
    return cb.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class D4(Codebook):
    id: str = "D4"
    codesz: int = D4_CODESZ
    packsz: Fraction = Fraction(1)
    opt_resid_scale: float = -1.0
    opt_scale: float = 1.21
    idx_dtype: np.dtype = dataclasses.field(default=np.dtype(np.uint8))

    def grid(self) -> np.ndarray:
        return d4_grid()

    def pack_idxs(self, idxs: np.ndarray) -> np.ndarray:
        return idxs.astype(np.uint8)

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        return packed.astype(np.int32)
