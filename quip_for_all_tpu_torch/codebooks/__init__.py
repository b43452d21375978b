"""Codebook records — the part of ``quip_for_all_tpu/codebooks`` that
loading needs: id, code size, packing factor, grids and index
(un)packing. All five are served: E8P12, E8P12RVQ4B, E8P12RVQ3B, D4 and
HI (``quantize`` waits for the quantization slice).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

import numpy as np

from .d4 import D4
from .e8p12 import E8P_CODESZ
from .e8p12_rvq3 import E8P12RVQ3B
from .e8p12_rvq4 import E8P12RVQ4B
from .hi import HI4B1C


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
    if name in ("E8P12RVQ4B", "E8P12RVQ3B"):
        cls = E8P12RVQ4B if name == "E8P12RVQ4B" else E8P12RVQ3B
        if opt_resid_scale is not None and opt_resid_scale > 0:
            return cls(opt_resid_scale=float(opt_resid_scale))
        return cls()
    if name == "D4":
        return D4()
    if name == "HI":
        return HI4B1C()
    raise ValueError(f"Invalid codebook {name!r}")


__all__ = ["Codebook", "D4", "E8P12RVQ3B", "E8P12RVQ4B", "HI4B1C",
           "get_codebook"]
