"""T1: ablations of a decode + matvec, to find what holds a fused decode
kernel below the byte bound: the decode, the per-plane products, or the
loads. Counterpart of the JAX package's ``tools/microbench_kernel.py``
(``make_call`` at :37, its ``pallas_call`` at :80), through the
hand-written CUDA kernels of ``csrc/mb_kernel.cu``.

x (m, K) with plane i's G = K/8 lanes at [i*G, (i+1)*G); words (N, G)
int32 in [0, 2^25): eight 3-bit fields at bits 3i and a parity bit at 24.

  prod    decode in registers, plane i = ((w >> 3i) & 7) - 2.25
          - 0.5*parity, one FMA per plane and row of x;
  nodec   the decode replaced by one convert: every plane is bf16(w)
          (int32 -> f32 -> bf16, each rounded to nearest even, as torch's
          int32 -> bf16);
  onedot  a tile of rows decoded into shared memory as bf16, then one
          matvec pass over it (the analogue of concatenating the planes
          for one dot);
  stream  every word read and summed: one f32 per row (the load floor).

out (m, N) bf16 = sum_i x_i @ plane_i^T in f32; stream gives (N,) f32 (the
JAX tool broadcasts the sum over each TN-row tile instead).

    python -m quip_for_all_tpu_torch.tools.microbench_kernel --N 4096 --K 4096 --m 8 --variants prod nodec onedot stream
"""
from __future__ import annotations

import argparse
import ctypes
from typing import List

import numpy as np
import torch

from ._timing import (BF16_OPS_PER_S, F32_OPS_PER_S, check_tensor, emit,
                      launch, library_us, measure, product_us,
                      resolve_device)

KERNEL = "mb_kernel"
SOURCE = "quip_for_all_tpu_torch/csrc/mb_kernel.cu"
REPLACES = "tools/microbench_kernel.py:80"
VARIANTS = ("prod", "nodec", "onedot", "stream")
_ID = {v: i for i, v in enumerate(VARIANTS)}


def e8p_planes(w: torch.Tensor) -> List[torch.Tensor]:
    """The 3-bit + parity decode of every word: 8 f32 planes (N, G), each
    value exact in bf16 (the JAX package's former ``_e8p_planes``)."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    off = -2.25 - 0.5 * ((u >> 24) & 1).to(torch.float32)
    return [((u >> (3 * i)) & 7).to(torch.float32) + off for i in range(8)]


def _planes_matmul(x, planes):
    G = planes[0].shape[1]
    xf = x.to(torch.float32)
    acc = None
    for i, v in enumerate(planes):
        d = xf[:, i * G:(i + 1) * G] @ v.T
        acc = d if acc is None else acc + d
    return acc.to(torch.bfloat16)


def prod_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _planes_matmul(x, e8p_planes(w))


def nodec_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    wb = w.to(torch.bfloat16).to(torch.float32)
    return _planes_matmul(x, [wb] * 8)


def onedot_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    wcat = torch.cat(e8p_planes(w), dim=1).to(torch.bfloat16)   # (N, 8G)
    return (x.to(torch.float32) @ wcat.to(torch.float32).T).to(
        torch.bfloat16)


def stream_ref(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32).sum(dim=1)


def _call(variant, fn, twin, x, w):
    check_tensor(w, "w", torch.int32, 2)
    N, G = w.shape
    if G % 4:
        raise ValueError(f"G={G} is not a multiple of 4")
    if x is not None:
        check_tensor(x, "x", torch.bfloat16, 2, w.device)
        if x.shape[1] != 8 * G:
            raise ValueError(f"x width {x.shape[1]} != 8*G={8 * G}")
    if w.device.type == "cpu":
        return twin(w) if x is None else twin(x, w)
    m = 1 if x is None else x.shape[0]
    out = (torch.empty(N, dtype=torch.float32, device=w.device)
           if x is None else
           torch.empty((m, N), dtype=torch.bfloat16, device=w.device))
    launch(KERNEL, "qfa_mb_kernel",
           [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
           + [ctypes.c_void_p],
           _ID[variant], None if x is None else x.data_ptr(), w.data_ptr(),
           out.data_ptr(), m, N, G,
           torch.cuda.current_stream(w.device).cuda_stream)
    fn.launches += 1
    return out


def prod(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper (``.launches`` counts kernel launches; a CPU tensor
    takes the twin and counts none). x (m, 8G) bf16, w (N, G) int32."""
    return _call("prod", prod, prod_ref, x, w)


def nodec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _call("nodec", nodec, nodec_ref, x, w)


def onedot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _call("onedot", onedot, onedot_ref, x, w)


def stream(w: torch.Tensor) -> torch.Tensor:
    """Row sums (N,) f32 of the words as f32."""
    return _call("stream", stream, stream_ref, None, w)


for _f in (prod, nodec, onedot, stream):
    _f.launches = 0
WRAPPERS = {"prod": prod, "nodec": nodec, "onedot": onedot, "stream": stream}
TWINS = {"prod": prod_ref, "nodec": nodec_ref, "onedot": onedot_ref,
         "stream": stream_ref}


def make_inputs(N: int, K: int, m: int, device, seed: int = 0):
    """The JAX tool's inputs: words in [0, 2^25), x ~ 0.1 N(0, 1) bf16."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 25, size=(N, K // 8),
                     dtype=np.int64).astype(np.int32)
    x = (rng.standard_normal((m, K)) * 0.1).astype(np.float32)
    return (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(w).to(device))


def run(N: int = 4096, K: int = 4096, m: int = 8, variants=VARIANTS,
        iters: int = 512, device="cuda") -> List[dict]:
    """Each variant against its twin and, on a card, timed: one record
    per variant (``_timing.measure``)."""
    dev = resolve_device(device)
    x, w = make_inputs(N, K, m, dev)
    lib = {"stream": library_us(lambda w: w.sum(1, dtype=torch.float32),
                                (w,))}
    lib["prod"] = lib["nodec"] = lib["onedot"] = product_us(
        torch.cat(e8p_planes(w), dim=1), m)
    G = K // 8
    recs = []
    for v in variants:
        if v == "stream":
            args, nbytes, ops, peak = (w,), N * G * 4 + N * 4, N * G, \
                F32_OPS_PER_S
        else:
            args = (x, w)
            nbytes, ops, peak = N * G * 4 + m * K * 2 + m * N * 2, \
                2 * m * N * K, BF16_OPS_PER_S
        recs.append(measure(
            WRAPPERS[v], TWINS[v], args, WRAPPERS[v], nbytes=nbytes, ops=ops,
            ops_per_s=peak, iters=iters, tool="microbench_kernel", variant=v,
            kernel=f"{KERNEL}:{v}", source=SOURCE, replaces=REPLACES, N=N,
            K=K, m=m, library_us=lib[v]))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(a.N, a.K, a.m, a.variants, a.iters, a.device))


if __name__ == "__main__":
    raise SystemExit(main())
