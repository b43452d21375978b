"""QuantizedTensor: runtime container for lattice-coded weights (nibble
layout), the PyTorch counterpart of ``quip_for_all_tpu/ops/qtensor.py``.

The runtime planes are bit-identical to the JAX package's: one int32 word
per 8-weight group holding 8 UNSIGNED nibbles, with a static affine decode

    weight_i = alpha * nib_i + beta,   nib_i = (word >> 4*i) & 0xF

  E8P12 (and each RVQ stage): nib = 2u + 1 - parity in {0..11},
      (alpha, beta) = (0.5, -2.75)
  half-integer signed family (D4; E8P12RVQ3B residual): nib = 2*weight + 8,
      (alpha, beta) = (0.5, -4)
  HI: nib = code, (alpha, beta) = (1, -7.5)

Plane columns are padded to multiples of 128 groups with zero words; every
consumer slices the pad off or zeroes the matching x lanes. Only E8P12 codes
convert to and from planes in this slice; the other codebooks' affine rows
are here because the fused kernel already takes their 1 or 2 plane sets.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..codebooks import Codebook
from ..codebooks import e8p12


@dataclasses.dataclass
class QuantizedTensor:
    """Lattice-coded weight matrix of logical shape (q_out, q_in).

    planes: int32 tensors of shape (q_out, ceil(q_in/8/128)*128), keyed
      "w0" (main) and, for the two-stage codebooks, "w1" (residual).
    """
    planes: Dict[str, torch.Tensor]
    codebook_id: str
    q_out: int
    q_in: int
    opt_resid_scale: float = -1.0
    layout: str = "nibble"

    def __post_init__(self):
        if self.layout != "nibble":
            raise NotImplementedError(
                f"runtime layout {self.layout!r} is not ported yet "
                "(ROADMAP.md queue 1, slice 9)")

    @property
    def group_cols(self) -> int:
        """Padded group count Gp (plane columns)."""
        return self.planes["w0"].shape[-1]

    @property
    def decode_affine(self):
        """Per-plane-set (alpha, beta), in sorted plane-key order."""
        return decode_affine(self.codebook_id, self.opt_resid_scale)

    def plane_list(self):
        return [self.planes[k] for k in sorted(self.planes)]


def decode_affine(codebook_id: str, opt_resid_scale: float = -1.0):
    E8P = (0.5, -2.75)    # nib = 2u + 1 - parity, weight = u - 2.5 ± 0.25
    SNIB = (0.5, -4.0)    # nib = 2*weight + 8
    if codebook_id == "E8P12":
        return (E8P,)
    if codebook_id == "E8P12RVQ4B":
        rs = opt_resid_scale
        return (E8P, (E8P[0] * rs, E8P[1] * rs))
    if codebook_id == "E8P12RVQ3B":
        rs = opt_resid_scale
        return (E8P, (SNIB[0] * rs, SNIB[1] * rs))
    if codebook_id == "D4":
        return (SNIB,)
    if codebook_id == "HI":
        return ((1.0, -7.5),)
    raise ValueError(codebook_id)


def _pad_cols(a: np.ndarray, mult: int = 128) -> np.ndarray:
    pad = (-a.shape[1]) % mult
    return a if pad == 0 else np.pad(a, ((0, 0), (0, pad)))


# ------------------------------------------------- encode helpers (numpy)

def _e8p_words_from_idx(idx16: np.ndarray) -> np.ndarray:
    """(..., G) uint16 E8P codes -> int32 affine-nibble word plane."""
    vals = e8p12.full_grid()[idx16.astype(np.int64)]      # (..., G, 8)
    # weight = 0.5*nib - 2.75 exactly, so nib = 2*weight + 5.5 in {0..11}
    nib = np.rint(vals * 2 + 5.5).astype(np.int64)
    assert nib.min() >= 0 and nib.max() <= 15
    word = np.zeros(idx16.shape, dtype=np.int64)
    for i in range(8):
        word |= nib[..., i] << (4 * i)
    return word.astype(np.uint32).view(np.int32)


@lru_cache(maxsize=None)
def e8p_word_table() -> np.ndarray:
    """(65536,) int32: the runtime word of every E8P12 code."""
    return _e8p_words_from_idx(np.arange(1 << 16, dtype=np.uint16))


def _vals_key(vals: np.ndarray) -> np.ndarray:
    """Encode an (..., 8) half-integer-grid row as a unique int64 key."""
    q = np.rint(vals * 4).astype(np.int64) + 64           # positive
    key = np.zeros(vals.shape[:-1], dtype=np.int64)
    for i in range(8):
        key = key * 129 + q[..., i]
    return key


@lru_cache(maxsize=None)
def _e8p_inverse_keys():
    """Sorted integer keys of the full E8P grid for word->idx recovery."""
    keys = _vals_key(e8p12.full_grid().astype(np.float64))
    order = np.argsort(keys)
    return keys[order], order.astype(np.int64)


def _e8p_idx_from_words(words: np.ndarray) -> np.ndarray:
    """int32 word plane -> uint16 E8P codes (exact inverse)."""
    w = words.view(np.uint32).astype(np.int64)
    vals = np.stack([((w >> (4 * i)) & 0xF).astype(np.float64)
                     for i in range(8)], axis=-1) * 0.5 - 2.75
    keys = _vals_key(vals)
    skeys, order = _e8p_inverse_keys()
    pos = np.clip(np.searchsorted(skeys, keys), 0, len(skeys) - 1)
    if not np.array_equal(skeys[pos], keys):
        raise ValueError("non-codeword in E8P plane")
    return order[pos].astype(np.uint16)


# ------------------------------------------------- raw idx <-> runtime

def from_raw_idxs(cb: Codebook, idxs: np.ndarray, q_out: int, q_in: int,
                  device="cpu") -> QuantizedTensor:
    """Raw int32 code indices (q_out, q_in/codesz) -> runtime planes."""
    if cb.id != "E8P12":
        raise NotImplementedError(
            f"{cb.id} planes are not ported yet (ROADMAP.md slice 2)")
    w0 = _e8p_words_from_idx(idxs.astype(np.int64).astype(np.uint16))
    planes = {"w0": torch.from_numpy(np.ascontiguousarray(_pad_cols(w0)))
              .to(device)}
    return QuantizedTensor(planes, cb.id, q_out, q_in)


def to_raw_idxs(qt: QuantizedTensor) -> np.ndarray:
    """Runtime planes -> raw int32 code indices (exact inverse)."""
    if qt.codebook_id != "E8P12":
        raise NotImplementedError(qt.codebook_id)
    w0 = qt.planes["w0"].cpu().numpy()[:, : qt.q_in // 8]
    return _e8p_idx_from_words(w0).astype(np.int64).astype(
        np.uint32).view(np.int32)


def to_checkpoint_idxs(qt: QuantizedTensor) -> np.ndarray:
    """Runtime planes -> reference checkpoint Qidxs array (numpy)."""
    raw = to_raw_idxs(qt)
    return raw.astype(np.int64).astype(np.uint16).view(np.int16)


def from_checkpoint_idxs(cb: Codebook, packed: np.ndarray, q_out: int,
                         q_in: int, device="cpu") -> QuantizedTensor:
    """Reference checkpoint Qidxs array -> runtime planes."""
    return from_raw_idxs(cb, cb.unpack_idxs(packed), q_out, q_in,
                         device=device)


__all__ = ["QuantizedTensor", "decode_affine", "from_raw_idxs",
           "to_raw_idxs", "from_checkpoint_idxs", "to_checkpoint_idxs",
           "e8p_word_table"]
