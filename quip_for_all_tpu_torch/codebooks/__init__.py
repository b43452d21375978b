"""Codebook records — the part of ``quip_for_all_tpu/codebooks`` that
loading needs: id, code size, packing factor and index unpacking.

Only E8P12 is served in this slice; the other four codebooks (D4, HI,
E8P12RVQ3B, E8P12RVQ4B) are queued for slice 2 of ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np

from .e8p12 import E8P_CODESZ

_NOT_PORTED = ("D4", "HI", "E8P12RVQ3B", "E8P12RVQ4B")


@dataclasses.dataclass(frozen=True)
class Codebook:
    """Checkpoint-side codebook contract: ``codesz`` weights per code index,
    ``packsz`` raw indices per stored element."""
    id: str
    codesz: int
    packsz: Fraction

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        """Checkpoint Qidxs array -> raw int32 code indices."""
        if self.id == "E8P12":
            return packed.view(np.uint16).astype(np.int32)
        raise NotImplementedError(self.id)


def get_codebook(name: str) -> Codebook:
    if name == "E8P12":
        return Codebook("E8P12", E8P_CODESZ, Fraction(1))
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"codebook {name!r} is not ported yet (ROADMAP.md queue 1, "
            "slice 2)")
    raise ValueError(f"Invalid codebook {name!r}")


__all__ = ["Codebook", "get_codebook"]
