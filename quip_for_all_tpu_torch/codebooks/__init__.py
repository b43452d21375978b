"""Codebook records — the part of ``quip_for_all_tpu/codebooks`` that
loading needs: id, code size, packing factor and index unpacking.

E8P12 and E8P12RVQ4B are served; the other three codebooks (D4, HI,
E8P12RVQ3B) are queued for slice 2 of ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

import numpy as np

from .e8p12 import E8P_CODESZ
from .e8p12_rvq4 import E8P12RVQ4B

_NOT_PORTED = ("D4", "HI", "E8P12RVQ3B")


@dataclasses.dataclass(frozen=True)
class Codebook:
    """Checkpoint-side codebook contract: ``codesz`` weights per code index,
    ``packsz`` raw indices per stored element."""
    id: str
    codesz: int
    packsz: Fraction
    opt_resid_scale: float = -1.0

    def unpack_idxs(self, packed: np.ndarray) -> np.ndarray:
        """Checkpoint Qidxs array -> raw int32 code indices."""
        if self.id == "E8P12":
            return packed.view(np.uint16).astype(np.int32)
        raise NotImplementedError(self.id)


def get_codebook(name: str, opt_resid_scale: Optional[float] = None):
    """The codebook record by id. ``opt_resid_scale`` None or <= 0 keeps
    the codebook's default (as the JAX package's ``get_codebook``)."""
    if name == "E8P12":
        return Codebook("E8P12", E8P_CODESZ, Fraction(1))
    if name == "E8P12RVQ4B":
        if opt_resid_scale is not None and opt_resid_scale > 0:
            return E8P12RVQ4B(opt_resid_scale=float(opt_resid_scale))
        return E8P12RVQ4B()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"codebook {name!r} is not ported yet (ROADMAP.md queue 1, "
            "slice 2)")
    raise ValueError(f"Invalid codebook {name!r}")


__all__ = ["Codebook", "E8P12RVQ4B", "get_codebook"]
