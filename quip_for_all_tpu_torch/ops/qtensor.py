"""QuantizedTensor: runtime container for lattice-coded weights, the
PyTorch counterpart of ``quip_for_all_tpu/ops/qtensor.py``. Seven runtime
layouts, bit-identical to the JAX package's (``LAYOUTS``).

**nibble** (the default): one int32 word per 8-weight group holding 8
UNSIGNED nibbles, with a static affine decode

    weight_i = alpha * nib_i + beta,   nib_i = (word >> 4*i) & 0xF

  E8P12 (and each RVQ stage): nib = 2u + 1 - parity in {0..11},
      (alpha, beta) = (0.5, -2.75)
  half-integer signed family (D4; E8P12RVQ3B residual): nib = 2*weight + 8,
      (alpha, beta) = (0.5, -4)
  HI: nib = code, (alpha, beta) = (1, -7.5)

Plane columns are padded to multiples of 128 groups with zero words; every
consumer slices the pad off or zeroes the matching x lanes. E8P12 uses one
plane ("w0"), E8P12RVQ4B two (main "w0", residual "w1").

The two **row-pair** layouts store fewer bits. Every E8P12 codeword entry is
u - 2.25 - 0.5*p with u in {0..5} and the parity p shared by the 8-weight
group. Each plane word holds 16-bit payloads of an output-row PAIR: row 2r
in the low half, row 2r+1 in the high half (h = 0 / 1 below).

**u3** (E8P12 only, ``qtensor.py:198-293`` there), Gp padded to 256:
  w0 (q_out/2, Gp)   bits 16h + 2i:        u & 3 at position i
  w1 (q_out/2, Gp/2) bit 16h + 8d + i:     u >> 2 of group d*Gp/2 + lane
  w2 (q_out/2, PL)   bit 16h + j:          parity of group j*PL + lane
(PL = ``u3_parity_lanes``). At q_in 4096 that is ~3.5 bits/weight: the
parity plane fills only 4 of the 16 bits of each half.

**pb** (E8P12RVQ4B only, ``qtensor.py:296-386`` there), Gp padded to 128:
  w0 (2, q_out/2, Gp) nibble lo4 = u0 | (u1 & 1) << 3 of position i at bits
                      16h + 4*(i mod 4) of w0[i div 4]
  w1 (q_out/2, Gp)    bits 16h + 2i:       u1 >> 1
  w2 (q_out/2, PL)    bits 16h + 2j (+1):  p0 (p1) of group j*PL + lane
(PL = ``pb_parity_lanes``, which need not divide Gp); ~6.5 bits/weight
against the nibble layout's 8.

**paired** (E8P12RVQ4B only, ``qtensor.py:35-56``, ``:574-606`` there), Gp
padded to 256, one output row per word:
  w0 (q_out, Gp)      bits 4i:             lo4 = u0 | (u1 & 1) << 3
  w1 (q_out, Gp/2)    bits 16h + 2i:       u1 >> 1 of group h*Gp/2 + lane
  w2 (q_out, Wp)      bits 2j (+1):        p0 (p1) of group j*Wp + lane
(Wp = ``paired_wp``, which divides Gp); ~7 bits/weight at q_in 4096.

Two layouts store the nibble words' own bytes in another order, so they
decode by the nibble layout's affine rows:

**bfp** (``qtensor.py:138-173`` there), even q_out: each nibble plane
becomes (2, q_out/2, Gp) int32; with we, wo the words of rows 2t and 2t+1,
  [0][t, g] = (we & 0xFFFF) | (wo << 16)             positions 0..3
  [1][t, g] = (we >> 16) | (wo & 0xFFFF0000)          positions 4..7
so ((w >> 4k) & 0x000F000F) | 0x43004300 holds, as two bf16 halves, 128
plus nibble 4*half + k of rows 2t and 2t+1.

**sw2 / sw4** (``qtensor.py:74-108`` there): the nibble planes viewed as
int16 / int8 subwords, (q_out, P*Gp) with P = 2 / 4, low subword first
(``split``). Subword j of group g sits at column P*g + j and holds nibbles
i = (8/P)*j + q at bits 4q.

Every codebook converts to and from planes (``from_raw_idxs``,
``to_raw_idxs``): E8P12 and E8P12RVQ4B in every layout their codes take,
D4, HI and E8P12RVQ3B in the nibble words and the layouts that keep their
bytes (bfp, sw2, sw4): the u-code layouts hold E8P12 codewords only.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from ..codebooks import e8p12
from ..codebooks.d4 import d4_grid
from ..codebooks.e8p12_rvq3 import e81b_grid
from ..utils.device import resolve_device

LAYOUTS = ("nibble", "u3", "pb", "paired", "bfp", "sw2", "sw4")
ROWPAIR_LAYOUTS = ("u3", "pb")
# the layouts whose planes decode by the u-code math, not the affine rows
UCODE_LAYOUTS = ("u3", "pb", "paired")
SPLIT = {"sw2": 2, "sw4": 4}


@dataclasses.dataclass
class QuantizedTensor:
    """Lattice-coded weight matrix of logical shape (q_out, q_in).

    planes: tensors keyed "w0", "w1", ... in the shapes and dtypes of the
    layout (module docstring): int32, or int16 / int8 in sw2 / sw4."""
    planes: Dict[str, torch.Tensor]
    codebook_id: str
    q_out: int
    q_in: int
    opt_resid_scale: float = -1.0
    layout: str = "nibble"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"runtime layout {self.layout!r} not in "
                             f"{LAYOUTS}")

    @property
    def split(self) -> int:
        """Subwords per int32 word of the plane storage (2 / 4 in sw2 /
        sw4, else 1)."""
        return SPLIT.get(self.layout, 1)

    @property
    def group_cols(self) -> int:
        """Padded group count Gp (columns of x_perm per position)."""
        return self.planes["w0"].shape[-1] // self.split

    @property
    def decode_affine(self):
        """Per-plane-set (alpha, beta), in sorted plane-key order. The
        nibble, bfp and sw layouts decode affinely; u3/pb/paired planes
        decode by the u-code math (module docstring)."""
        if self.layout in UCODE_LAYOUTS:
            raise ValueError(f"decode_affine on the {self.layout} layout")
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


def resolve_layout(codebook_id: str, layout: Optional[str], q_out: int
                   ) -> str:
    """The runtime layout a caller asked for, where the JAX package reads
    QFA_E8P_U3 / QFA_RVQ_PB / QFA_RVQ_PAIRED / QFA_BFP / QFA_SPLIT_DECODE:
    None means nibble; "u3" takes E8P12 only, "pb" and "paired"
    E8P12RVQ4B only; "bfp", "sw2" and "sw4" take every ported codebook;
    u3, pb and bfp pair output rows and need an even q_out."""
    if layout is None or layout == "nibble":
        return "nibble"
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in (None, "
                         + ", ".join(repr(v) for v in LAYOUTS) + ")")
    need = {"u3": "E8P12", "pb": "E8P12RVQ4B",
            "paired": "E8P12RVQ4B"}.get(layout)
    if need is not None and codebook_id != need:
        raise ValueError(f"layout {layout!r} takes {need}, not "
                         f"{codebook_id}")
    if layout in ("u3", "pb", "bfp") and q_out % 2:
        raise ValueError(f"layout {layout!r} pairs output rows: q_out "
                         f"{q_out} is odd")
    return layout


def u3_parity_lanes(Gp: int) -> int:
    """u3 parity-plane lane width: smallest 128-multiple PL dividing Gp
    with Gp/PL <= 16 one-bit fields per 16-bit row payload."""
    pl = 128
    while Gp // pl > 16 or Gp % pl != 0:
        pl += 128
    return pl


def pb_parity_lanes(Gp: int) -> int:
    """pb parity-plane lane width: smallest 128-multiple with 8*PL >= Gp
    (eight 2-bit (p0, p1) fields per 16-bit row payload)."""
    pl = 128
    while 8 * pl < Gp:
        pl += 128
    return pl


def paired_wp(Gp: int) -> int:
    """paired parity-plane lane width: smallest 128-multiple dividing Gp
    that covers Gp groups in <= 16 two-bit fields (Gp itself when none
    smaller does)."""
    for k in range(1, Gp // 128 + 1):
        w = 128 * k
        if Gp % w == 0 and 16 * w >= Gp:
            return w
    return Gp


def _pad_cols(a: np.ndarray, mult: int = 128) -> np.ndarray:
    pad = (-a.shape[1]) % mult
    return a if pad == 0 else np.pad(a, ((0, 0), (0, pad)))


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


# ------------------------------------------------- encode helpers (numpy)

def _e8p_words_of(idx16: np.ndarray) -> np.ndarray:
    """(..., G) uint16 E8P codes -> int32 affine-nibble word plane, from
    the codes' decoded values."""
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
    return _e8p_words_of(np.arange(1 << 16, dtype=np.uint16))


def _e8p_words_from_idx(idx16: np.ndarray) -> np.ndarray:
    """(..., G) uint16 E8P codes -> int32 word plane (a lookup in
    ``e8p_word_table``)."""
    return e8p_word_table()[idx16.astype(np.int64)]


def _e8p_uv_from_idx(idx16: np.ndarray):
    """(...) uint16 E8P codes -> (u (..., 8) in {0..5}, parity (...)) with
    weight = u - 2.25 - 0.5*parity (the parity is uniform per codeword)."""
    vals = e8p12.full_grid()[idx16.astype(np.int64)]      # (..., 8)
    nib = np.rint(vals * 2 + 5.5).astype(np.int64)
    p = 1 - (nib[..., 0] & 1)
    u = (nib - 1 + p[..., None]) >> 1
    assert u.min() >= 0 and u.max() <= 5
    return u, p


@lru_cache(maxsize=None)
def e8p_uv_table():
    """((65536, 8) uint8 u, (65536,) uint8 parity) of every E8P12 code."""
    u, p = _e8p_uv_from_idx(np.arange(1 << 16, dtype=np.uint16))
    return u.astype(np.uint8), p.astype(np.uint8)


@lru_cache(maxsize=None)
def _e8p_word_order():
    """The E8P12 words sorted (as uint32) and the codes in that order."""
    words = e8p_word_table().view(np.uint32).astype(np.int64)
    order = np.argsort(words)
    return words[order], order.astype(np.int64)


@lru_cache(maxsize=8)
def _e8p_word_order_on(device: torch.device):
    sw, order = _e8p_word_order()
    return torch.from_numpy(sw).to(device), torch.from_numpy(order).to(device)


def _e8p_idx_from_words(words: torch.Tensor) -> np.ndarray:
    """int32 word plane (a tensor, searched on its own device) -> int64
    E8P codes on the host (exact inverse: every code has its own word)."""
    sw, order = _e8p_word_order_on(words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    pos = torch.searchsorted(sw, w).clamp_(max=len(sw) - 1)
    if not torch.equal(sw[pos], w):
        raise ValueError("non-codeword in E8P plane")
    return order[pos].cpu().numpy()


# ------------------------------------------------- row-pair packers (torch)
# u and parity arrive as integer tensors on any device; the planes come
# back on the same device, so the random builder packs on the card.

def _rowpair16(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Two (q_out/2, C) tensors of 16-bit payloads -> (q_out/2, C) int32
    words, even row in the low half."""
    return _as_i32((even.to(torch.int64) & 0xFFFF)
                   | (odd.to(torch.int64) << 16))


def _unpair16(w: torch.Tensor) -> torch.Tensor:
    """(q_out/2, C) row-pair words -> (q_out, C) int64 16-bit payloads."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(-1, w.shape[-1])


def u3_planes_from_up(u: torch.Tensor, p: torch.Tensor, q_out: int, G: int
                      ) -> Dict[str, torch.Tensor]:
    """(u (q_out, G, 8) in {0..7}, parity (q_out, G)) -> u3 planes
    (``_u3_planes_from_up`` in the JAX package)."""
    assert q_out % 2 == 0
    dev = u.device
    Gp = -(-G // 256) * 256
    Gh = Gp // 2
    PL = u3_parity_lanes(Gp)
    L16 = torch.zeros((q_out, Gp), dtype=torch.int32, device=dev)
    for i in range(8):
        L16[:, :G] |= (u[..., i].to(torch.int32) & 3) << (2 * i)
    H16 = torch.zeros((q_out, Gh), dtype=torch.int32, device=dev)
    for d in (0, 1):
        lo_g, hi_g = d * Gh, min((d + 1) * Gh, G)
        if lo_g >= G:
            break
        for i in range(8):
            H16[:, :hi_g - lo_g] |= ((u[:, lo_g:hi_g, i].to(torch.int32) >> 2)
                                     << (8 * d + i))
    P16 = torch.zeros((q_out, PL), dtype=torch.int32, device=dev)
    for j in range(Gp // PL):
        lo_g, hi_g = j * PL, min((j + 1) * PL, G)
        if lo_g >= G:
            break
        P16[:, :hi_g - lo_g] |= p[:, lo_g:hi_g].to(torch.int32) << j
    return {"w0": _rowpair16(L16[0::2], L16[1::2]),
            "w1": _rowpair16(H16[0::2], H16[1::2]),
            "w2": _rowpair16(P16[0::2], P16[1::2])}


def pb_planes_from_uv(u0: torch.Tensor, p0: torch.Tensor, u1: torch.Tensor,
                      p1: torch.Tensor, q_out: int, G: int
                      ) -> Dict[str, torch.Tensor]:
    """(u0, p0, u1, p1) of the main and residual codes -> pb planes
    (``_pb_planes_from_uv`` in the JAX package). u0 (q_out, G, 8) in
    {0..7}, u1 in {0..7}; parities (q_out, G) in {0, 1}."""
    assert q_out % 2 == 0
    dev = u0.device
    Gp = -(-G // 128) * 128
    PL = pb_parity_lanes(Gp)
    L = torch.zeros((q_out, Gp), dtype=torch.int64, device=dev)
    H16 = torch.zeros((q_out, Gp), dtype=torch.int32, device=dev)
    for i in range(8):
        a, b = u0[..., i].to(torch.int64), u1[..., i].to(torch.int64)
        L[:, :G] |= (a | ((b & 1) << 3)) << (4 * i)
        H16[:, :G] |= (b.to(torch.int32) >> 1) << (2 * i)
    we, wo = L[0::2], L[1::2]
    lo = _rowpair16(we & 0xFFFF, wo & 0xFFFF)             # positions 0..3
    hi = _rowpair16(we >> 16, wo >> 16)                   # positions 4..7
    pp = (p0.to(torch.int32) | (p1.to(torch.int32) << 1))
    P16 = torch.zeros((q_out, PL), dtype=torch.int32, device=dev)
    for j in range(-(-Gp // PL)):
        lo_g, hi_g = j * PL, min((j + 1) * PL, G)
        if lo_g >= G:
            break
        P16[:, :hi_g - lo_g] |= pp[:, lo_g:hi_g] << (2 * j)
    return {"w0": torch.stack([lo, hi]),
            "w1": _rowpair16(H16[0::2], H16[1::2]),
            "w2": _rowpair16(P16[0::2], P16[1::2])}


def u3_up_from_planes(planes: Dict[str, torch.Tensor]):
    """u3 planes -> (u (q_out, Gp, 8), parity (q_out, Gp)) int64, exact."""
    L16 = _unpair16(planes["w0"])
    H16 = _unpair16(planes["w1"])
    P16 = _unpair16(planes["w2"])
    Gp, PL = L16.shape[-1], P16.shape[-1]
    lo = torch.stack([(L16 >> (2 * i)) & 3 for i in range(8)], dim=-1)
    hi = torch.cat([torch.stack([(H16 >> (8 * d + i)) & 1 for i in range(8)],
                                dim=-1) for d in (0, 1)], dim=1)
    p = torch.cat([(P16 >> j) & 1 for j in range(Gp // PL)], dim=1)[:, :Gp]
    return lo + 4 * hi, p


def pb_uv_from_planes(planes: Dict[str, torch.Tensor]):
    """pb planes -> (u0, p0, u1, p1) int64 over Gp groups, exact. u0/u1
    (q_out, Gp, 8), parities (q_out, Gp)."""
    A16 = [_unpair16(planes["w0"][h]) for h in (0, 1)]
    H16 = _unpair16(planes["w1"])
    P16 = _unpair16(planes["w2"])
    Gp, PL = H16.shape[-1], P16.shape[-1]
    pp = torch.cat([(P16 >> (2 * j)) & 3 for j in range(-(-Gp // PL))],
                   dim=1)[:, :Gp]
    lo4 = torch.stack([(A16[i // 4] >> (4 * (i % 4))) & 0xF
                       for i in range(8)], dim=-1)
    hi = torch.stack([(H16 >> (2 * i)) & 3 for i in range(8)], dim=-1)
    return lo4 & 7, pp & 1, 2 * hi + (lo4 >> 3), pp >> 1


def _nibble_plane(u: torch.Tensor, p: torch.Tensor, G: int) -> torch.Tensor:
    """(u (q_out, Gp, 8), p (q_out, Gp)) -> nibble word plane
    nib = 2u + 1 - p, padded to 128 groups; exact for any u in {0..7}."""
    Gn = -(-G // 128) * 128
    W = torch.zeros((u.shape[0], Gn), dtype=torch.int64, device=u.device)
    for i in range(8):
        W[:, :G] |= ((2 * u[:, :G, i] + 1 - p[:, :G]) << (4 * i))
    return _as_i32(W)


def u3_to_nibble(qt: QuantizedTensor) -> QuantizedTensor:
    """u3 -> nibble re-layout at the (u, parity) level: exact for any u in
    {0..7}, so random-bit planes convert too."""
    assert qt.layout == "u3" and qt.codebook_id == "E8P12"
    u, p = u3_up_from_planes(qt.planes)
    return QuantizedTensor({"w0": _nibble_plane(u, p, qt.q_in // 8)},
                           qt.codebook_id, qt.q_out, qt.q_in,
                           qt.opt_resid_scale)


def pb_to_nibble(qt: QuantizedTensor) -> QuantizedTensor:
    """pb -> RVQ4B nibble re-layout at the (u, parity) level (exact; grid
    membership not required)."""
    assert qt.layout == "pb" and qt.codebook_id == "E8P12RVQ4B"
    u0, p0, u1, p1 = pb_uv_from_planes(qt.planes)
    G = qt.q_in // 8
    return QuantizedTensor({"w0": _nibble_plane(u0, p0, G),
                            "w1": _nibble_plane(u1, p1, G)},
                           qt.codebook_id, qt.q_out, qt.q_in,
                           qt.opt_resid_scale)


# ------------------------------------------------- paired packer (torch)

def paired_planes_from_uv(u0: torch.Tensor, p0: torch.Tensor,
                          u1: torch.Tensor, p1: torch.Tensor, q_out: int,
                          G: int) -> Dict[str, torch.Tensor]:
    """(u0, p0, u1, p1) of the main and residual codes -> paired planes
    (``_paired_planes_from_idx`` in the JAX package), on u0's device.
    u0 (q_out, G, 8) in {0..7}, u1 in {0..5}; parities (q_out, G)."""
    dev = u0.device
    Gp = -(-G // 256) * 256
    Gh, Wp = Gp // 2, paired_wp(Gp)
    L = torch.zeros((q_out, Gp), dtype=torch.int64, device=dev)
    for i in range(8):
        a, b = u0[..., i].to(torch.int64), u1[..., i].to(torch.int64)
        L[:, :G] |= (a | ((b & 1) << 3)) << (4 * i)
    H = torch.zeros((q_out, Gh), dtype=torch.int64, device=dev)
    for h in (0, 1):
        lo_g, hi_g = h * Gh, min((h + 1) * Gh, G)
        if lo_g >= G:
            break
        for i in range(8):
            H[:, :hi_g - lo_g] |= ((u1[:, lo_g:hi_g, i].to(torch.int64) >> 1)
                                   << (16 * h + 2 * i))
    pp = p0.to(torch.int64) | (p1.to(torch.int64) << 1)
    P = torch.zeros((q_out, Wp), dtype=torch.int64, device=dev)
    for j in range(Gp // Wp):
        lo_g, hi_g = j * Wp, min((j + 1) * Wp, G)
        if lo_g >= G:
            break
        P[:, :hi_g - lo_g] |= pp[:, lo_g:hi_g] << (2 * j)
    return {"w0": _as_i32(L), "w1": _as_i32(H), "w2": _as_i32(P)}


def paired_uv_from_planes(planes: Dict[str, torch.Tensor]):
    """paired planes -> (u0, p0, u1, p1) int64 over Gp groups, exact.
    u0/u1 (q_out, Gp, 8), parities (q_out, Gp)."""
    L, Hw, Pw = (planes[k].to(torch.int64) & 0xFFFFFFFF
                 for k in ("w0", "w1", "w2"))
    Gp, Wp = L.shape[-1], Pw.shape[-1]
    lo4 = torch.stack([(L >> (4 * i)) & 0xF for i in range(8)], dim=-1)
    hi = torch.cat([torch.stack([(Hw >> (16 * h + 2 * i)) & 3
                                 for i in range(8)], dim=-1)
                    for h in (0, 1)], dim=1)
    pp = torch.cat([(Pw >> (2 * j)) & 3 for j in range(Gp // Wp)], dim=1)
    return lo4 & 7, pp & 1, 2 * hi + (lo4 >> 3), pp >> 1


def paired_to_nibble(qt: QuantizedTensor) -> QuantizedTensor:
    """paired -> RVQ4B nibble re-layout at the (u, parity) level (exact;
    grid membership not required)."""
    assert qt.layout == "paired" and qt.codebook_id == "E8P12RVQ4B"
    u0, p0, u1, p1 = paired_uv_from_planes(qt.planes)
    G = qt.q_in // 8
    return QuantizedTensor({"w0": _nibble_plane(u0, p0, G),
                            "w1": _nibble_plane(u1, p1, G)},
                           qt.codebook_id, qt.q_out, qt.q_in,
                           qt.opt_resid_scale)


# ------------------------------------------------- same-bytes re-layouts

def to_subword(qt: QuantizedTensor, P: int) -> QuantizedTensor:
    """nibble -> sw{P}: a view of the same bytes as int16 (P = 2) or int8
    (P = 4), (q_out, P*Gp), low subword first."""
    assert qt.layout == "nibble" and P in (2, 4)
    dt = torch.int16 if P == 2 else torch.int8
    return dataclasses.replace(
        qt, planes={k: v.contiguous().view(dt) for k, v in qt.planes.items()},
        layout=f"sw{P}")


def from_subword(qt: QuantizedTensor) -> QuantizedTensor:
    """sw{P} -> nibble (exact inverse of ``to_subword``, a view)."""
    if qt.split == 1:
        return qt
    return dataclasses.replace(
        qt, planes={k: v.contiguous().view(torch.int32)
                    for k, v in qt.planes.items()}, layout="nibble")


def to_bfp(qt: QuantizedTensor) -> QuantizedTensor:
    """nibble -> bfp: each (q_out, Gp) plane -> (2, q_out/2, Gp), on its
    device, in unsigned 32-bit arithmetic (module docstring)."""
    assert qt.layout == "nibble" and qt.q_out % 2 == 0
    planes = {}
    for k, v in qt.planes.items():
        w = v.to(torch.int64) & 0xFFFFFFFF
        we, wo = w[0::2], w[1::2]
        planes[k] = _as_i32(torch.stack(
            [(we & 0xFFFF) | ((wo & 0xFFFF) << 16),
             (we >> 16) | (wo & 0xFFFF0000)]))
    return dataclasses.replace(qt, planes=planes, layout="bfp")


def from_bfp(qt: QuantizedTensor) -> QuantizedTensor:
    """bfp -> nibble (exact inverse of ``to_bfp``)."""
    if qt.layout != "bfp":
        return qt
    planes = {}
    for k, v in qt.planes.items():
        w = v.to(torch.int64) & 0xFFFFFFFF
        a, b = w[0], w[1]
        we = (a & 0xFFFF) | ((b & 0xFFFF) << 16)
        wo = (a >> 16) | (b & 0xFFFF0000)
        planes[k] = _as_i32(torch.stack([we, wo], dim=1).reshape(
            -1, v.shape[-1]))
    return dataclasses.replace(qt, planes=planes, layout="nibble")


def to_nibble(qt: QuantizedTensor) -> QuantizedTensor:
    """Any layout -> nibble planes of the same codes (exact)."""
    return {"u3": u3_to_nibble, "pb": pb_to_nibble,
            "paired": paired_to_nibble, "bfp": from_bfp,
            "sw2": from_subword, "sw4": from_subword}.get(
                qt.layout, lambda q: q)(qt)


def relayout(qt: QuantizedTensor, layout: str) -> QuantizedTensor:
    """nibble -> the same codes in bfp or sw2/sw4 (the layouts that keep
    the nibble words' bytes)."""
    if layout == "bfp":
        return to_bfp(qt)
    if layout in SPLIT:
        return to_subword(qt, SPLIT[layout])
    assert layout == "nibble", layout
    return qt


# ------------------------------------------------- raw idx <-> runtime

def _nibble_words_from_vals(vals: np.ndarray) -> np.ndarray:
    """(..., G, 8) half-integer values in [-4, 3.5] -> int32 biased-nibble
    words (nib = 2*v + 8, decode weight = 0.5*nib - 4)."""
    t = np.rint(vals * 2).astype(np.int64) + 8
    if t.min() < 0 or t.max() > 15:
        raise ValueError("values outside the biased-nibble range")
    word = np.zeros(vals.shape[:-1], dtype=np.int64)
    for i in range(8):
        word |= t[..., i] << (4 * i)
    return word.astype(np.uint32).view(np.int32)


def _nibble_vals_from_words(words: np.ndarray) -> np.ndarray:
    w = words.view(np.uint32).astype(np.int64)
    return np.stack([(((w >> (4 * i)) & 0xF) - 8) * 0.5 for i in range(8)],
                    axis=-1)


def _rows_by_key(grid: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """The grid row of every (..., k) half-integer value row (exact)."""
    def key(v):
        q = np.rint(np.asarray(v, np.float64) * 4).astype(np.int64) + 64
        k = np.zeros(q.shape[:-1], dtype=np.int64)
        for i in range(q.shape[-1]):
            k = k * 129 + q[..., i]
        return k
    gk = key(grid)
    order = np.argsort(gk)
    keys = key(vals)
    pos = np.searchsorted(gk[order], keys)
    pos = np.minimum(pos, len(order) - 1)
    if not np.array_equal(gk[order][pos], keys):
        raise ValueError("a plane word holds no codeword")
    return order[pos]


def _affine_words(cb_id: str, idxs: np.ndarray, q_out: int, q_in: int
                  ) -> Dict[str, np.ndarray]:
    """The nibble word planes (unpadded) of D4, HI and E8P12RVQ3B codes
    (``from_raw_idxs`` in the JAX package, ``qtensor.py:744-765``)."""
    if cb_id == "E8P12RVQ3B":
        u = np.ascontiguousarray(idxs).view(np.uint32).astype(np.int64)
        return {"w0": _e8p_words_from_idx((u >> 8).astype(np.uint16)),
                "w1": _nibble_words_from_vals(e81b_grid()[u & 0xFF])}
    if cb_id == "D4":
        vals = d4_grid()[idxs.astype(np.int64)]        # (q_out, q_in/4, 4)
        return {"w0": _nibble_words_from_vals(
            vals.reshape(q_out, q_in // 8, 8))}
    # HI: one code a weight, the code itself the nibble
    codes = idxs.astype(np.int64).reshape(q_out, q_in // 8, 8)
    word = np.zeros((q_out, q_in // 8), dtype=np.int64)
    for i in range(8):
        word |= (codes[..., i] & 0xF) << (4 * i)
    return {"w0": word.astype(np.uint32).view(np.int32)}


@lru_cache(maxsize=None)
def affine_word_table(cb_id: str) -> np.ndarray:
    """The 16-bit nibble half-word of every D4 code (256,: 4 weights), or
    the int32 nibble word of every E8P12RVQ3B residual code (256,)."""
    if cb_id == "D4":
        return (_nibble_words_from_vals(
            np.concatenate([d4_grid(), np.full((256, 4), -4.0)], axis=1))
            .view(np.uint32) & 0xFFFF).astype(np.int32)
    return _nibble_words_from_vals(e81b_grid())


def from_raw_idxs(cb, idxs: np.ndarray, q_out: int, q_in: int,
                  device="cuda", layout: Optional[str] = None
                  ) -> QuantizedTensor:
    """Raw int32 code indices (q_out, q_in/codesz) -> runtime planes in
    ``layout`` (``resolve_layout``) on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    layout = resolve_layout(cb.id, layout, q_out)
    G = q_in // 8
    ors = float(cb.opt_resid_scale)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if cb.id in ("D4", "HI", "E8P12RVQ3B"):
        planes = {k: dev(_pad_cols(v))
                  for k, v in _affine_words(cb.id, idxs, q_out, q_in).items()}
        return relayout(QuantizedTensor(planes, cb.id, q_out, q_in, ors),
                        layout)
    if cb.id == "E8P12":
        idx16 = idxs.astype(np.int64).astype(np.uint16)
        if layout == "u3":
            u, p = _e8p_uv_from_idx(idx16)
            return QuantizedTensor(
                u3_planes_from_up(dev(u), dev(p), q_out, G), cb.id, q_out,
                q_in, ors, layout)
        planes = {"w0": dev(_pad_cols(_e8p_words_from_idx(idx16)))}
        return relayout(QuantizedTensor(planes, cb.id, q_out, q_in, ors),
                        layout)
    u32 = np.ascontiguousarray(idxs).view(np.uint32).astype(np.int64)
    main = (u32 >> 16).astype(np.uint16)
    resid = (u32 & 0xFFFF).astype(np.uint16)
    if layout in ("pb", "paired"):
        u0, p0 = _e8p_uv_from_idx(main)
        u1, p1 = _e8p_uv_from_idx(resid)
        pack = pb_planes_from_uv if layout == "pb" else paired_planes_from_uv
        return QuantizedTensor(pack(dev(u0), dev(p0), dev(u1), dev(p1),
                                    q_out, G),
                               cb.id, q_out, q_in, ors, layout)
    planes = {"w0": dev(_pad_cols(_e8p_words_from_idx(main))),
              "w1": dev(_pad_cols(_e8p_words_from_idx(resid)))}
    return relayout(QuantizedTensor(planes, cb.id, q_out, q_in, ors), layout)


def to_raw_idxs(qt: QuantizedTensor) -> np.ndarray:
    """Runtime planes -> raw int32 code indices (exact inverse)."""
    qt = to_nibble(qt)
    ncols = qt.q_in // 8

    def codes(key):
        return _e8p_idx_from_words(qt.planes[key][:, :ncols])
    if qt.codebook_id == "E8P12":
        return codes("w0").astype(np.uint32).view(np.int32)
    if qt.codebook_id == "E8P12RVQ4B":
        return ((codes("w0") << 16) | codes("w1")).astype(
            np.uint32).view(np.int32)

    def words(key):
        return qt.planes[key].cpu().numpy()[:, :ncols]
    if qt.codebook_id == "E8P12RVQ3B":
        resid = _rows_by_key(e81b_grid(), _nibble_vals_from_words(words("w1")))
        return ((codes("w0") << 8) | resid).astype(np.uint32).view(np.int32)
    if qt.codebook_id == "D4":
        vals = _nibble_vals_from_words(words("w0")).reshape(
            qt.q_out, qt.q_in // 4, 4)
        return _rows_by_key(d4_grid(), vals).astype(np.int32)
    if qt.codebook_id == "HI":
        w = words("w0").view(np.uint32).astype(np.int64)
        out = np.empty((qt.q_out, qt.q_in), dtype=np.int32)
        for i in range(8):
            out[:, i::8] = ((w >> (4 * i)) & 0xF).astype(np.int32)
        return out
    raise ValueError(qt.codebook_id)


def to_checkpoint_idxs(qt: QuantizedTensor) -> np.ndarray:
    """Runtime planes -> reference checkpoint Qidxs array (numpy)."""
    from ..codebooks import get_codebook
    raw = to_raw_idxs(qt)
    if qt.codebook_id == "E8P12":
        return raw.astype(np.int64).astype(np.uint16).view(np.int16)
    if qt.codebook_id in ("D4", "HI", "E8P12RVQ3B"):
        return get_codebook(qt.codebook_id).pack_idxs(raw)
    return raw


def from_checkpoint_idxs(cb, packed: np.ndarray, q_out: int, q_in: int,
                         device="cuda", layout: Optional[str] = None
                         ) -> QuantizedTensor:
    """Reference checkpoint Qidxs array -> runtime planes on ``device``."""
    return from_raw_idxs(cb, cb.unpack_idxs(packed), q_out, q_in,
                         device=device, layout=layout)


__all__ = ["QuantizedTensor", "LAYOUTS", "ROWPAIR_LAYOUTS", "UCODE_LAYOUTS",
           "SPLIT", "decode_affine", "resolve_layout", "from_raw_idxs",
           "to_raw_idxs", "from_checkpoint_idxs", "to_checkpoint_idxs",
           "e8p_word_table", "e8p_uv_table", "affine_word_table",
           "u3_parity_lanes",
           "pb_parity_lanes", "paired_wp", "u3_planes_from_up",
           "pb_planes_from_uv", "paired_planes_from_uv", "u3_up_from_planes",
           "pb_uv_from_planes", "paired_uv_from_planes", "u3_to_nibble",
           "pb_to_nibble", "paired_to_nibble", "to_subword", "from_subword",
           "to_bfp", "from_bfp", "to_nibble", "relayout"]
