"""Codebook records — counterpart of ``quip_for_all_tpu/codebooks``: id,
code size, packing factor, grids, index (un)packing and nearest-codeword
rounding (``quantize``, ``base.py``) for all five: E8P12, E8P12RVQ4B,
E8P12RVQ3B, D4 and HI.
"""
from __future__ import annotations

from typing import Optional

from .base import Codebook, nearest_codeword
from .d4 import D4
from .e8p12 import E8P12
from .e8p12_rvq3 import E8P12RVQ3B
from .e8p12_rvq4 import E8P12RVQ4B
from .hi import HI4B1C

codebook_id = {
    "D4": D4,
    "E8P12": E8P12,
    "HI": HI4B1C,
    "E8P12RVQ3B": E8P12RVQ3B,
    "E8P12RVQ4B": E8P12RVQ4B,
}


def get_codebook(name: str, opt_resid_scale: Optional[float] = None):
    """The codebook record by id. ``opt_resid_scale`` None or <= 0 keeps
    the codebook's default (as the JAX package's ``get_codebook``)."""
    if name not in codebook_id:
        raise ValueError(
            f"Invalid codebook {name!r}; choose from {sorted(codebook_id)}")
    cls = codebook_id[name]
    if name in ("E8P12RVQ4B", "E8P12RVQ3B") and opt_resid_scale is not None \
            and opt_resid_scale > 0:
        return cls(opt_resid_scale=float(opt_resid_scale))
    return cls()


__all__ = ["Codebook", "D4", "E8P12", "E8P12RVQ3B", "E8P12RVQ4B", "HI4B1C",
           "codebook_id", "get_codebook", "nearest_codeword"]
