"""Nearest-codeword rounding and the codebook base — counterpart of
``quip_for_all_tpu/codebooks/base.py``.

Rounding maximizes 2<x, g> - ||g||^2 over the grid (the same objective as
minimizing ||x - g||^2) in f32 on the tensor's device, over chunks of the
grid so the (m, chunk) score matrix stays within a memory budget. Ties go
to the first index, as the JAX scan's: the first maximum inside a chunk
(``torch.max``), a strictly greater score across chunks. The score product
is a plain ``torch.matmul`` (on the card ``torch.addmm``, the norms in its
epilogue): the JAX package rounds with an XLA product and argmax, no
Pallas kernel.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

# the JAX package's grid chunk (its _ARGMAX_CHUNK); the port's default on
# the CPU, so both packages reduce over the same chunks there
ARGMAX_CHUNK = 8192
# the score matrix a chunk may take on the card
CARD_SCORE_BYTES = 4 << 30


def card_chunk(m: int, n: int) -> int:
    """The grid chunk on the card: the widest power of two (at least
    ``ARGMAX_CHUNK``, at most the grid) whose (m, chunk) f32 score matrix
    fits ``CARD_SCORE_BYTES``."""
    c = ARGMAX_CHUNK
    while c * 2 <= n and m * c * 2 * 4 <= CARD_SCORE_BYTES:
        c *= 2
    return c


def nearest_codeword(X: torch.Tensor, grid: torch.Tensor,
                     grid_norm: torch.Tensor, chunk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of X (m, codesz) -> (nearest grid rows (m, codesz), their
    indices (m,) int32). ``chunk`` None: ``ARGMAX_CHUNK`` on the CPU,
    ``card_chunk`` on the card."""
    m = X.shape[0]
    n = grid.shape[0]
    cpu = X.device.type == "cpu"
    if chunk is None:
        chunk = ARGMAX_CHUNK if cpu else card_chunk(m, n)
    X2 = 2.0 * X

    def score(lo, hi):
        if cpu:       # the JAX package's two roundings, in its order
            return torch.matmul(X2, grid[lo:hi].T).sub_(grid_norm[lo:hi])
        # on the card -||g||^2 rides the product's epilogue: the same two
        # roundings (the f32 sum, then the add), one pass over the scores
        return torch.addmm(-grid_norm[lo:hi], X2, grid[lo:hi].T)
    if n <= chunk:
        idx = torch.max(score(0, n), dim=1).indices
        return grid[idx], idx.to(torch.int32)
    if n % chunk:
        raise ValueError(f"grid of {n} rows in chunks of {chunk}")
    best = best_idx = None
    for base in range(0, n, chunk):
        val, loc = torch.max(score(base, base + chunk), dim=1)
        if best is None:
            best, best_idx = val, loc
            continue
        better = val > best
        best = torch.where(better, val, best)
        best_idx = torch.where(better, loc + base, best_idx)
    return grid[best_idx], best_idx.to(torch.int32)


@lru_cache(maxsize=32)
def _grid_tensors(grid_fn, device: torch.device, dtype: torch.dtype):
    g = grid_fn()
    return (torch.as_tensor(g, device=device).to(dtype),
            torch.as_tensor((g.astype(np.float32) ** 2).sum(-1),
                            device=device).to(dtype))


def grid_tensors(grid_fn, device, dtype=torch.float32):
    """A numpy grid function's grid and squared norms as tensors on
    ``device``, made once per device."""
    return _grid_tensors(grid_fn, torch.device(device), dtype)


class Codebook:
    """The behaviour every codebook record shares: its grid's norms,
    rounding through ``nearest_codeword`` and the default index packing.
    Records are frozen dataclasses with ``id``, ``codesz``, ``opt_scale``
    (the per-tensor scale the quantizer divides by), ``idx_dtype`` (the
    checkpoint dtype of packed indices), ``packsz`` and
    ``opt_resid_scale``."""

    def grid(self) -> np.ndarray:
        raise NotImplementedError

    def grid_norm(self) -> np.ndarray:
        g = self.grid()
        return (g * g).sum(-1)

    def quantize(self, X: torch.Tensor, chunk: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Round rows of X (m, codesz) to codewords: (values, int32
        indices), on X's device."""
        g, gn = grid_tensors(self.grid, X.device, X.dtype)
        return nearest_codeword(X, g, gn, chunk)

    def pack_idxs(self, idxs: np.ndarray) -> np.ndarray:
        """(out, in/codesz) raw indices -> checkpoint array of idx_dtype."""
        return idxs.astype(self.idx_dtype)

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        return packed.astype(np.int64).astype(np.int32)
