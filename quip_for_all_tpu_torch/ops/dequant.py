"""Dense codebook decode from runtime word planes, in plain torch ops — the
counterpart of ``quip_for_all_tpu/ops/dequant_xla.py`` (every runtime
layout).

Used above the fused kernel's crossover (decode once, then one large
matmul) and as a reference in tests. The u3, pb and paired layouts decode
by the u-code math of ``ops/qtensor.py``, in the JAX package's order of f32
operations, so the dense weights are bit-equal to its ``decode_weights``;
bfp and sw planes decode as the nibble words they re-lay.
"""
from __future__ import annotations

from typing import List

import torch

from .qtensor import QuantizedTensor, _unpair16, to_nibble


def nibble_planes(w: torch.Tensor) -> List[torch.Tensor]:
    """int32 word plane (..., G) -> 8 float32 nibble planes.

    ``>>`` on int32 is an arithmetic shift, so every nibble (the 7th
    included) is masked with 0xF: a word with bit 31 set still yields
    nibble 7 in 8..15.
    """
    return [((w >> (4 * i)) & 0xF).to(torch.float32) for i in range(8)]


def _u3_positions(qt: QuantizedTensor, dtype) -> List[torch.Tensor]:
    """weight = u - 2.25 - 0.5*p with u = lo2 + 4*hi1, parity per group
    (``_u3_positions`` in the JAX package)."""
    L16 = _unpair16(qt.planes["w0"])            # (q_out, Gp)
    H16 = _unpair16(qt.planes["w1"])            # (q_out, Gp/2)
    P16 = _unpair16(qt.planes["w2"])            # (q_out, PL)
    Gp, PL = L16.shape[-1], P16.shape[-1]
    par = torch.cat([(P16 >> j) & 1 for j in range(Gp // PL)],
                    dim=-1)[:, :Gp]
    const = -2.25 - 0.5 * par.to(torch.float32)
    out = []
    for i in range(8):
        lo = ((L16 >> (2 * i)) & 3).to(torch.float32)
        hi = torch.cat([(H16 >> (8 * d + i)) & 1 for d in (0, 1)],
                       dim=-1).to(torch.float32)
        out.append((lo + 4.0 * hi + const).to(dtype))
    return out


def _pb_positions(qt: QuantizedTensor, dtype) -> List[torch.Tensor]:
    """value = u0 + rs*u1 - 2.25*(1+rs) - 0.5*(p0 + rs*p1)[group]
    (``_pb_positions`` in the JAX package)."""
    rs = qt.opt_resid_scale
    A16 = [_unpair16(qt.planes["w0"][h]) for h in (0, 1)]
    H16 = _unpair16(qt.planes["w1"])            # (q_out, Gp) 2-bit fields
    P16 = _unpair16(qt.planes["w2"])            # (q_out, PL) 2-bit pairs
    Gp, PL = H16.shape[-1], P16.shape[-1]
    pcat = torch.cat([(P16 >> (2 * j)) & 3 for j in range(-(-Gp // PL))],
                     dim=-1)[:, :Gp]
    p0 = (pcat & 1).to(torch.float32)
    p1 = (pcat >> 1).to(torch.float32)
    const = -2.25 * (1.0 + rs) - 0.5 * (p0 + rs * p1)
    out = []
    for i in range(8):
        lo4 = (A16[i // 4] >> (4 * (i % 4))) & 0xF
        b = (lo4 >> 3).to(torch.float32)
        u0 = (lo4 & 7).to(torch.float32)
        hi = ((H16 >> (2 * i)) & 3).to(torch.float32)
        out.append((u0 + rs * (2.0 * hi + b) + const).to(dtype))
    return out


def _paired_positions(qt: QuantizedTensor, dtype) -> List[torch.Tensor]:
    """value = u0 + rs*u1 - 2.25*(1+rs) - 0.5*(p0 + rs*p1)[group], one row
    per word (``_paired_positions`` in the JAX package)."""
    rs = qt.opt_resid_scale
    L, Hw, Pw = (qt.planes[k].to(torch.int64) & 0xFFFFFFFF
                 for k in ("w0", "w1", "w2"))
    Gp, Wp = L.shape[-1], Pw.shape[-1]
    delta = torch.cat([((Pw >> (2 * j)) & 1).to(torch.float32)
                       + rs * ((Pw >> (2 * j + 1)) & 1).to(torch.float32)
                       for j in range(Gp // Wp)], dim=-1)     # (q_out, Gp)
    const = -2.25 * (1.0 + rs) - 0.5 * delta
    out = []
    for i in range(8):
        lo4 = (L >> (4 * i)) & 0xF
        b = (lo4 >> 3).to(torch.float32)
        u0 = (lo4 & 7).to(torch.float32)
        hi = torch.cat([((Hw >> (16 * h + 2 * i)) & 3).to(torch.float32)
                        for h in (0, 1)], dim=-1)            # (q_out, Gp)
        out.append((u0 + rs * (2.0 * hi + b) + const).to(dtype))
    return out


def decode_positions(qt: QuantizedTensor, dtype=torch.float32
                     ) -> List[torch.Tensor]:
    """-> list of 8 (q_out, Gp) planes; plane i holds weight 8g+i. bfp and
    sw planes go back to their nibble words first (same values)."""
    if qt.layout == "u3":
        return _u3_positions(qt, dtype)
    if qt.layout == "pb":
        return _pb_positions(qt, dtype)
    if qt.layout == "paired":
        return _paired_positions(qt, dtype)
    qt = to_nibble(qt)
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
