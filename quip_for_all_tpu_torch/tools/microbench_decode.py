"""T2: E8P decode of raw 16-bit codes inside a fused matvec, beside a load
floor and a dense bf16 matvec. Counterpart of the JAX package's
``tools/microbench_decode.py`` (``make_run`` at :115, its ``pallas_call``
at :168), through the hand-written CUDA kernels of ``csrc/mb_decode.cu``.

  lane    a 256 x 8 f32 table of |pattern| (abs_grid_bytes / 4) in shared
          memory, one read per weight;
  lane_b  two 256-entry u32 tables of pattern bytes, a byte extract;
  stream  every code read and summed, signed: one f32 per row;
  dense   x @ W^T with W (N, K) bf16, a hand-written matvec.

x (m, K) f32 is in the grouped layout x_perm[:, j*G + g] = x[:, 8g + j];
codes (N, G) int16 decode as the tool's ``_common``: signs = c & 0xFF,
abs = c >> 8 of the 16-bit code, the parity fold, the +-0.25 offset, plane
i taking column ``_SHUFFLE[i]``. out (m, N) f32 (stream: (N,) f32).

    python -m quip_for_all_tpu_torch.tools.microbench_decode --N 4096 --K 4096 --m 8 --strategies lane lane_b stream dense
"""
from __future__ import annotations

import argparse
import ctypes
from typing import List

import numpy as np
import torch

from ..codebooks import e8p12
from ._timing import (F32_OPS_PER_S, check_tensor, emit, launch,
                      library_us, measure, product_us, resolve_device)

KERNEL = "mb_decode"
SOURCE = "quip_for_all_tpu_torch/csrc/mb_decode.cu"
REPLACES = "tools/microbench_decode.py:168"
STRATEGIES = ("lane", "lane_b", "stream", "dense")
_ID = {v: i for i, v in enumerate(STRATEGIES)}
_SHUF = tuple(int(i) for i in e8p12._SHUFFLE)


def tables_np():
    """(cols (256, 8) f32 = abs_grid_bytes / 4, lohi (2, 256) int32 with
    bytes 0-3 and 4-7 of each pattern packed little-endian)."""
    byts = e8p12.abs_grid_bytes().astype(np.int64)
    lo = np.zeros(256, np.int64)
    hi = np.zeros(256, np.int64)
    for j in range(4):
        lo |= (byts[:, j] & 0xFF) << (8 * j)
        hi |= (byts[:, j + 4] & 0xFF) << (8 * j)
    lohi = np.stack([lo, hi]).astype(np.uint32).view(np.int32)
    return byts.astype(np.float32) / 4.0, lohi


def _common(codes):
    c = codes.to(torch.int32) & 0xFFFF
    signs = c & 0xFF
    p = signs ^ (signs >> 4)
    p = p ^ (p >> 2)
    p = p ^ (p >> 1)
    parity = p & 1
    offs = 0.25 - 0.5 * parity.to(torch.float32)
    return signs ^ parity, (c >> 8).long(), offs


def _planes_matmul(x, planes):
    G = planes[0].shape[1]
    acc = None
    for i, v in enumerate(planes):
        d = x[:, i * G:(i + 1) * G] @ v.T
        acc = d if acc is None else acc + d
    return acc


def _signed(v, signs, ii, offs):
    bit = (signs >> (7 - ii)) & 1
    return torch.where(bit == 1, -v, v) + offs


def lane_ref(x: torch.Tensor, codes: torch.Tensor,
             cols: torch.Tensor) -> torch.Tensor:
    signs, ab, offs = _common(codes)
    return _planes_matmul(x, [_signed(cols[ab, ii], signs, ii, offs)
                              for ii in _SHUF])


def lane_b_ref(x: torch.Tensor, codes: torch.Tensor,
               lohi: torch.Tensor) -> torch.Tensor:
    signs, ab, offs = _common(codes)
    planes = []
    for ii in _SHUF:
        word = lohi[0 if ii < 4 else 1][ab]
        b = (word >> (8 * (ii % 4))) & 0xFF
        b = torch.where(b >= 128, b - 256, b)
        planes.append(_signed(b.to(torch.float32) * 0.25, signs, ii, offs))
    return _planes_matmul(x, planes)


def stream_ref(codes: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32).sum(dim=1)


def dense_ref(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return x @ W.to(torch.float32).T


def _call(variant, fn, twin, x, w, table=None):
    wdt = torch.bfloat16 if variant == "dense" else torch.int16
    check_tensor(w, "W" if variant == "dense" else "codes", wdt, 2)
    N = w.shape[0]
    K = w.shape[1] * (1 if variant == "dense" else 8)
    if K % 64:
        raise ValueError(f"K={K} is not a multiple of 64")
    if x is not None:
        check_tensor(x, "x", torch.float32, 2, w.device)
        if x.shape[1] != K:
            raise ValueError(f"x width {x.shape[1]} != K={K}")
    if table is not None:
        tdt, tshape = ((torch.float32, (256, 8)) if variant == "lane"
                       else (torch.int32, (2, 256)))
        check_tensor(table, "table", tdt, 2, w.device)
        if tuple(table.shape) != tshape:
            raise ValueError(f"table {tuple(table.shape)} != {tshape}")
    if w.device.type == "cpu":
        args = [a for a in (x, w, table) if a is not None]
        return twin(*args)
    m = 1 if x is None else x.shape[0]
    out = (torch.empty(N, dtype=torch.float32, device=w.device)
           if x is None else
           torch.empty((m, N), dtype=torch.float32, device=w.device))
    launch(KERNEL, "qfa_mb_decode",
           [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
           + [ctypes.c_void_p],
           _ID[variant], None if x is None else x.data_ptr(), w.data_ptr(),
           None if table is None else table.data_ptr(), out.data_ptr(), m, N,
           K, torch.cuda.current_stream(w.device).cuda_stream)
    fn.launches += 1
    return out


def lane(x: torch.Tensor, codes: torch.Tensor,
         cols: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper (``.launches`` counts kernel launches; a CPU tensor
    takes the twin and counts none). x (m, K) f32, codes (N, K/8) int16,
    cols (256, 8) f32 -> (m, N) f32."""
    return _call("lane", lane, lane_ref, x, codes, cols)


def lane_b(x: torch.Tensor, codes: torch.Tensor,
           lohi: torch.Tensor) -> torch.Tensor:
    return _call("lane_b", lane_b, lane_b_ref, x, codes, lohi)


def stream(codes: torch.Tensor) -> torch.Tensor:
    """Row sums (N,) f32 of the codes as signed int16."""
    return _call("stream", stream, stream_ref, None, codes)


def dense(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return _call("dense", dense, dense_ref, x, W)


for _f in (lane, lane_b, stream, dense):
    _f.launches = 0
WRAPPERS = {"lane": lane, "lane_b": lane_b, "stream": stream, "dense": dense}
TWINS = {"lane": lane_ref, "lane_b": lane_b_ref, "stream": stream_ref,
         "dense": dense_ref}


def make_inputs(N: int, K: int, m: int, device, seed: int = 0):
    """The JAX tool's inputs: (x_perm f32, codes int16, W (N, K) bf16 of
    the decoded codes in x_perm's lane order, cols, lohi)."""
    rng = np.random.default_rng(seed)
    G = K // 8
    idx16 = rng.integers(0, 1 << 16, size=(N, G),
                         dtype=np.uint16).view(np.int16)
    x = (rng.standard_normal((m, K)) * 0.1).astype(np.float32)
    w_dec = e8p12.full_grid()[idx16.view(np.uint16).astype(np.int32)]
    w_perm = w_dec.transpose(0, 2, 1).reshape(N, K)
    x_perm = x.reshape(m, G, 8).transpose(0, 2, 1).reshape(m, K)
    cols, lohi = tables_np()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(x_perm), t(idx16), t(w_perm).to(torch.bfloat16), t(cols),
            t(lohi))


def run(N: int = 4096, K: int = 4096, m: int = 8, strategies=STRATEGIES,
        iters: int = 512, device="cuda") -> List[dict]:
    dev = resolve_device(device)
    x, codes, W, cols, lohi = make_inputs(N, K, m, dev)
    lib = {"stream": library_us(lambda c: c.sum(1, dtype=torch.float32),
                                (codes,))}
    lib["lane"] = lib["lane_b"] = lib["dense"] = product_us(W, m)
    G = K // 8
    io = m * K * 4 + m * N * 4
    plan = {"lane": ((x, codes, cols), N * G * 2 + io + cols.numel() * 4),
            "lane_b": ((x, codes, lohi), N * G * 2 + io + lohi.numel() * 4),
            "stream": ((codes,), N * G * 2 + N * 4),
            "dense": ((x, W), N * K * 2 + io)}
    recs = []
    for s in strategies:
        args, nbytes = plan[s]
        ops = N * G if s == "stream" else 2 * m * N * K
        recs.append(measure(
            WRAPPERS[s], TWINS[s], args, WRAPPERS[s], nbytes=nbytes, ops=ops,
            ops_per_s=F32_OPS_PER_S, iters=iters, tool="microbench_decode",
            variant=s, kernel=f"{KERNEL}:{s}", source=SOURCE,
            replaces=REPLACES, N=N, K=K, m=m, library_us=lib[s]))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                    choices=STRATEGIES)
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(a.N, a.K, a.m, a.strategies, a.iters, a.device))


if __name__ == "__main__":
    raise SystemExit(main())
