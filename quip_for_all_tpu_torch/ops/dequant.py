"""Dense codebook decode from affine nibble word planes, in plain torch ops —
the counterpart of ``quip_for_all_tpu/ops/dequant_xla.py`` (nibble layout).

Used above the fused kernel's crossover (decode once, then one large
matmul) and as a reference in tests.
"""
from __future__ import annotations

from typing import List

import torch

from .qtensor import QuantizedTensor


def nibble_planes(w: torch.Tensor) -> List[torch.Tensor]:
    """int32 word plane (..., G) -> 8 float32 nibble planes.

    ``>>`` on int32 is an arithmetic shift, so every nibble (the 7th
    included) is masked with 0xF: a word with bit 31 set still yields
    nibble 7 in 8..15.
    """
    return [((w >> (4 * i)) & 0xF).to(torch.float32) for i in range(8)]


def decode_positions(qt: QuantizedTensor, dtype=torch.float32
                     ) -> List[torch.Tensor]:
    """-> list of 8 (q_out, Gp) planes; plane i holds weight 8g+i."""
    affine = qt.decode_affine
    keys = sorted(qt.planes)
    assert len(keys) == len(affine), (keys, affine)
    beta = sum(b for _, b in affine)
    acc = None
    for key, (alpha, _) in zip(keys, affine):
        nibs = nibble_planes(qt.planes[key])
        if acc is None:
            acc = [alpha * v for v in nibs]
        else:
            acc = [a + alpha * v for a, v in zip(acc, nibs)]
    return [(v + beta).to(dtype) for v in acc]


def decode_weights(qt: QuantizedTensor, dtype=torch.bfloat16
                   ) -> torch.Tensor:
    """Decode to a dense (q_out, q_in) weight matrix."""
    w = torch.stack(decode_positions(qt, dtype), dim=-1)   # (q_out, Gp, 8)
    # pad groups sit at the end of the padded column range
    return w.reshape(qt.q_out, -1)[:, : qt.q_in].to(dtype)
