"""T5: the bfp zero-convert decode against the int32 nibble body it
replaces, after a probe of how an int32 word's halves read as bf16.
Counterpart of the JAX package's ``tools/microbench_bfp.py``:

  discover_bitcast_order  (:61, ``pallas_call`` at :78): the hand-written
      probe ``csrc/mb_bfp_probe.cu`` reads each word as a __nv_bfloat162;
      classified as the tool classifies its bitcast;
  bfp   ``make_bfp_call`` (:138, :162): the port's K10
      (``csrc/bfp_decode_matmul.cu``) on the words packed by ``pack_bfp``
      in the order the probe reports, which is the ``to_bfp`` layout;
  base  ``make_base_call`` (:182, :201): the port's K1
      (``csrc/fused_decode_matmul.cu``) on the words.

Both compute out = 0.5 * (x . nib) - 2.75 * rowsum(x) in bf16 with the E8P
affine and no scale vector (the tool's bfp folds the +128 of its magic
into the row-sum term; K10 subtracts it per plane: the same function). x is
in the grouped layout x_perm[:, i*Gp + g] = x[:, 8g + i].

    python -m quip_for_all_tpu_torch.tools.microbench_bfp --shapes 4096x4096,12288x4096 --m 8
"""
from __future__ import annotations

import argparse
import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..ops import fused_matmul as fm
from ..ops import layout_matmul as lm
from ._timing import (BF16_OPS_PER_S, HBM_BYTES_PER_S, check_tensor, emit,
                      event_us, graph_us, launch, measure, product_us,
                      resolve_device)
from .microbench_tn import decoded

ALPHA, BETA = 0.5, -2.75
AFFINE = ((ALPHA, BETA),)
KERNEL = "mb_bfp_probe"
SOURCE = {"probe": "quip_for_all_tpu_torch/csrc/mb_bfp_probe.cu",
          "bfp": "quip_for_all_tpu_torch/csrc/bfp_decode_matmul.cu",
          "base": "quip_for_all_tpu_torch/csrc/fused_decode_matmul.cu"}
REPLACES = {"probe": "tools/microbench_bfp.py:78",
            "bfp": "tools/microbench_bfp.py:162",
            "base": "tools/microbench_bfp.py:201"}
# the order K10 (and ``ops/qtensor.py`` ``to_bfp``) decode: output row 2t
# in the low half of the word, row 2t + 1 in the high half
K10_ORDER = (True, True)


def bitcast_probe_ref(w: torch.Tensor) -> torch.Tensor:
    """(S, L) int32 -> (2S, L) bf16: row 2s the words' low halves, row
    2s + 1 their high halves (torch's view, little-endian)."""
    S, L = w.shape
    return w.contiguous().view(torch.bfloat16).reshape(S, L, 2).permute(
        0, 2, 1).reshape(2 * S, L)


def bitcast_probe(w: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper (``.launches`` counts kernel launches; a CPU tensor
    takes the twin and counts none)."""
    check_tensor(w, "w", torch.int32, 2)
    if w.device.type == "cpu":
        return bitcast_probe_ref(w)
    S, L = w.shape
    out = torch.empty((2 * S, L), dtype=torch.bfloat16, device=w.device)
    launch(KERNEL, "qfa_mb_bfp_probe",
           [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
           w.data_ptr(), out.data_ptr(), S, L,
           torch.cuda.current_stream(w.device).cuda_stream)
    bitcast_probe.launches += 1
    return out


bitcast_probe.launches = 0


def probe_words(S: int = 8, L: int = 128) -> np.ndarray:
    """The tool's pattern: word s holds bf16(2s) in its low half and
    bf16(2s + 1) in its high half, broadcast over L lanes."""
    bits = (np.arange(2 * S, dtype=np.float32).view(np.uint32) >> 16
            ).astype(np.uint64)
    words = ((bits[1::2] << 16) | bits[0::2]).astype(np.uint32).view(np.int32)
    return np.broadcast_to(words[:, None], (S, L)).copy()


def classify(col: np.ndarray) -> Tuple[bool, bool]:
    """(interleaved, lo_first) from column 0 of the probe's (2S, L) output,
    as the tool classifies it."""
    seq = np.arange(col.shape[0], dtype=np.float32)
    S = col.shape[0] // 2
    if np.array_equal(col, seq):
        return True, True
    if np.array_equal(col, seq.reshape(S, 2)[:, ::-1].reshape(-1)):
        return True, False
    if np.array_equal(col, np.concatenate([seq[0::2], seq[1::2]])):
        return False, True
    if np.array_equal(col, np.concatenate([seq[1::2], seq[0::2]])):
        return False, False
    raise RuntimeError(f"unrecognized bitcast order: {col.tolist()}")


def discover_bitcast_order(device="cuda") -> Tuple[bool, bool]:
    dev = resolve_device(device)
    out = bitcast_probe(torch.from_numpy(probe_words()).to(dev))
    return classify(out[:, 0].float().cpu().numpy())


def probe_record(device) -> dict:
    """The probe launched once on the tool's pattern, held bit for bit
    against its twin, and the order it reports. On a card its time is that
    of 16 warm graph calls on the one 4 KB input: launch overhead, not a
    load, so it is not made L2-cold."""
    w = torch.from_numpy(probe_words()).to(device)
    before = bitcast_probe.launches
    got = bitcast_probe(w)
    want = bitcast_probe_ref(w)
    ok = torch.equal(got.view(torch.int16), want.view(torch.int16))
    order = classify(got[:, 0].float().cpu().numpy())
    nbytes = w.numel() * 8
    err = float((got.float() - want.float()).abs().max())
    rec = dict(tool="microbench_bfp", variant="probe", kernel=KERNEL,
               source=SOURCE["probe"], replaces=REPLACES["probe"],
               N=w.shape[0], K=w.shape[1], m=0, library_us=None,
               device=(torch.cuda.get_device_name(w.device)
                       if w.device.type == "cuda" else "cpu"),
               ok=ok, max_abs_err=err,
               rel_err=err / float(want.float().abs().max()),
               tol="bit-equal", bytes=nbytes,
               bound_us=nbytes / HBM_BYTES_PER_S * 1e6, bound_by="bytes",
               us=None, plain_us=None, gbps=None, pct_of_bound=None,
               interleaved=order[0], lo_first=order[1])
    if w.device.type == "cuda":
        us = graph_us(lambda i: bitcast_probe(w), 16)
        rec.update(us=us, plain_us=event_us(lambda i: bitcast_probe_ref(w)),
                   gbps=nbytes / us * 1e-3,
                   pct_of_bound=100 * rec["bound_us"] / us)
    rec["launches"] = bitcast_probe.launches - before
    return rec


def pack_bfp(words: torch.Tensor, interleaved: bool, lo_first: bool
             ) -> torch.Tensor:
    """(N, Gp) int32 nibble words -> (2, N/2, Gp) int32, the tool's
    ``pack_bfp`` (A = nibbles 0-3, B = 4-7, one output row a 16-bit half)
    stacked; at (True, True) bit-equal to ``to_bfp``'s planes."""
    N = words.shape[0]
    w = words.to(torch.int64) & 0xFFFFFFFF
    halves = []
    for qlo in (0, 4):
        h = (w >> (4 * qlo)) & 0xFFFF             # nibbles qlo..qlo+3
        r0, r1 = (h[0::2], h[1::2]) if interleaved else (h[:N // 2],
                                                         h[N // 2:])
        lo, hi = (r0, r1) if lo_first else (r1, r0)
        v = (hi << 16) | lo
        halves.append(torch.where(v >= 2 ** 31, v - 2 ** 32, v))
    return torch.stack(halves).to(torch.int32)


def bfp_call(x_perm, planes):
    return lm.bfp_decode_matmul(x_perm, [planes], AFFINE)


def bfp_ref(x_perm, planes):
    return lm.bfp_decode_matmul_ref(x_perm, [planes], AFFINE)


def base_call(x_perm, words):
    return fm.fused_decode_matmul(x_perm, [words], AFFINE)


def base_ref(x_perm, words):
    return fm.fused_decode_matmul_ref(x_perm, [words], AFFINE)


def make_inputs(N: int, K: int, m: int, device, seed: int = 0):
    """The tool's inputs: random 32-bit words (N, Gp), x_nat ~ N(0, 1/K)
    in the grouped layout, bf16."""
    rng = np.random.default_rng(seed)
    G = K // 8
    Gp = -(-G // 128) * 128
    words = rng.integers(0, 1 << 32, size=(N, Gp),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    x_nat = (rng.standard_normal((m, K)) / np.sqrt(K)).astype(np.float32)
    xg = np.zeros((m, 8, Gp), np.float32)
    xg[:, :, :G] = x_nat.reshape(m, G, 8).transpose(0, 2, 1)
    return (torch.from_numpy(xg.reshape(m, 8 * Gp)).to(
        device=device, dtype=torch.bfloat16), torch.from_numpy(words).to(device))


def run(shapes: str = "4096x4096,12288x4096", m: int = 8, iters: int = 64,
        device="cuda") -> List[dict]:
    dev = resolve_device(device)
    probe = probe_record(dev)
    order = (probe["interleaved"], probe["lo_first"])
    recs = [probe]
    if order != K10_ORDER:
        probe["ok"] = False
        probe["error"] = (f"bitcast order {order}: K10 decodes the "
                          f"{K10_ORDER} layout; bfp not run")
        return recs
    for s in shapes.split(","):
        N, K = (int(v) for v in s.split("x"))
        x, words = make_inputs(N, K, m, dev)
        Gp = words.shape[1]
        lib = product_us(decoded(words), m)
        planes = pack_bfp(words, *order)
        io = m * 8 * Gp * 2 + m * N * 2
        for name, call, twin, arg, counter in (
                ("base", base_call, base_ref, words, fm.fused_decode_matmul),
                ("bfp", bfp_call, bfp_ref, planes, lm.bfp_decode_matmul)):
            recs.append(measure(
                call, twin, (x, arg), counter, nbytes=N * Gp * 4 + io,
                ops=2 * m * N * 8 * Gp, ops_per_s=BF16_OPS_PER_S,
                iters=iters, tool="microbench_bfp", variant=name,
                kernel=counter.__name__, source=SOURCE[name],
                replaces=REPLACES[name], N=N, K=K, m=m, library_us=lib))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="4096x4096,12288x4096")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(a.shapes, a.m, a.iters, a.device))


if __name__ == "__main__":
    raise SystemExit(main())
