"""T4: the production nibble body and a decode-free floor, swept over the
rows one block computes. Counterpart of the JAX package's
``tools/microbench_tn.py`` (``make_nibble_call`` at :55, ``make_dma_call``
at :91), through the hand-written CUDA kernels of ``csrc/mb_tn.cu``.

  nib  K1's function with one plane set and the E8P affine (0.5, -2.75):
       out = 0.5 * (x_perm . nib(w)) - 2.75 * rowsum(x_perm), bf16;
  dma  one plane's dot, no decode: out = x_perm[:, :Gp] @ (w & 0xF)^T.

The TPU tool sweeps TN, the output rows of one sequential grid step; the
H100 analogue is the rows of one block (``ROWS_PER_BLOCK``, 4 rows a
warp), at the same total warps. The shapes are the tool's (Llama-2-7B's
fused qkv, gate/up padded to 22528 rows, down) and the unpadded gate/up
22016 = 2^9 * 43, which the kernel masks.

    python -m quip_for_all_tpu_torch.tools.microbench_tn --shapes 12288x4096,22528x4096,4096x11264 --m 8
"""
from __future__ import annotations

import argparse
import ctypes
from typing import List

import numpy as np
import torch

from ..ops.fused_matmul import fused_decode_matmul_ref
from ._timing import (BF16_OPS_PER_S, check_tensor, emit, launch, measure,
                      product_us, resolve_device)

KERNEL = "mb_tn"
SOURCE = "quip_for_all_tpu_torch/csrc/mb_tn.cu"
REPLACES = {"nib": "tools/microbench_tn.py:73",
            "dma": "tools/microbench_tn.py:102"}
ALPHA, BETA = 0.5, -2.75       # E8P affine
ROWS_PER_BLOCK = (16, 32, 64, 128)
SHAPES = "12288x4096,22528x4096,4096x11264,22016x4096"


def nib_ref(x_perm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return fused_decode_matmul_ref(x_perm, [w], ((ALPHA, BETA),))


def dma_ref(x_perm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    Gp = w.shape[1]
    return (x_perm[:, :Gp].to(torch.float32)
            @ (w & 0xF).to(torch.float32).T).to(torch.bfloat16)


def _call(variant, fn, twin, x_perm, w, rows_per_block):
    check_tensor(w, "w", torch.int32, 2)
    check_tensor(x_perm, "x_perm", torch.bfloat16, 2, w.device)
    q_out, Gp = w.shape
    if x_perm.shape[1] != 8 * Gp or Gp % 4:
        raise ValueError(f"x_perm width {x_perm.shape[1]} != 8*Gp={8 * Gp} "
                         "or Gp not a multiple of 4")
    if rows_per_block not in ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block {rows_per_block} not in "
                         f"{ROWS_PER_BLOCK}")
    if w.device.type == "cpu":
        return twin(x_perm, w)
    m = x_perm.shape[0]
    out = torch.empty((m, q_out), dtype=torch.bfloat16, device=w.device)
    launch(KERNEL, "qfa_mb_tn",
           [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
           + [ctypes.c_float] * 2 + [ctypes.c_void_p],
           int(variant == "dma"), rows_per_block, x_perm.data_ptr(),
           w.data_ptr(), out.data_ptr(), m, q_out, Gp, ALPHA, BETA,
           torch.cuda.current_stream(w.device).cuda_stream)
    fn.launches += 1
    return out


def nib(x_perm: torch.Tensor, w: torch.Tensor,
        rows_per_block: int = 16) -> torch.Tensor:
    """Kernel wrapper (``.launches`` counts kernel launches; a CPU tensor
    takes the twin and counts none). x_perm (m, 8*Gp) bf16, w (q_out, Gp)
    int32 -> (m, q_out) bf16."""
    return _call("nib", nib, nib_ref, x_perm, w, rows_per_block)


def dma(x_perm: torch.Tensor, w: torch.Tensor,
        rows_per_block: int = 16) -> torch.Tensor:
    return _call("dma", dma, dma_ref, x_perm, w, rows_per_block)


nib.launches = dma.launches = 0
WRAPPERS = {"nib": nib, "dma": dma}
TWINS = {"nib": nib_ref, "dma": dma_ref}


def make_inputs(N: int, K: int, m: int, device, seed: int = 0):
    """The JAX tool's words (random 32 bits, Gp = G rounded up to 128);
    x random (the tool times on a constant x) in the grouped layout with
    zero pad lanes."""
    rng = np.random.default_rng(seed)
    G = K // 8
    Gp = -(-G // 128) * 128
    words = rng.integers(0, 1 << 32, size=(N, Gp),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    x = np.zeros((m, 8, Gp), np.float32)
    x[:, :, :G] = rng.standard_normal((m, 8, G)) / np.sqrt(K)
    return (torch.from_numpy(x.reshape(m, 8 * Gp)).to(
        device=device, dtype=torch.bfloat16), torch.from_numpy(words).to(device))


def decoded(w: torch.Tensor) -> torch.Tensor:
    """W (q_out, 8*Gp) bf16 in x_perm's lane order: the library's input."""
    nibs = torch.stack([(w >> (4 * i)) & 0xF for i in range(8)], dim=1)
    return (nibs.reshape(w.shape[0], -1).to(torch.float32) * ALPHA
            + BETA).to(torch.bfloat16)


def run(shapes: str = SHAPES, m: int = 8, iters: int = 64,
        rows_per_block=ROWS_PER_BLOCK, device="cuda") -> List[dict]:
    dev = resolve_device(device)
    recs = []
    for s in shapes.split(","):
        N, K = (int(v) for v in s.split("x"))
        x, w = make_inputs(N, K, m, dev)
        Gp = w.shape[1]
        # dma's own function: one plane's nibbles, decoded beforehand
        lib = {"dma": product_us(w & 0xF, m),
               "nib": product_us(decoded(w), m)}
        for rpb in rows_per_block:
            for v in ("dma", "nib"):
                planes = N * Gp * 4
                nbytes = planes + m * (Gp if v == "dma" else 8 * Gp) * 2 \
                    + m * N * 2
                ops = 2 * m * N * (Gp if v == "dma" else 8 * Gp)
                recs.append(measure(
                    lambda a, b, v=v, r=rpb: WRAPPERS[v](a, b, r), TWINS[v],
                    (x, w), WRAPPERS[v], nbytes=nbytes, ops=ops,
                    ops_per_s=BF16_OPS_PER_S, iters=iters,
                    tool="microbench_tn", variant=v,
                    kernel=f"{KERNEL}:{v}", source=SOURCE,
                    replaces=REPLACES[v], N=N, K=K, m=m,
                    rows_per_block=rpb, library_us=lib[v]))
        del x, w
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--rows-per-block", type=int, nargs="+",
                    default=list(ROWS_PER_BLOCK), choices=ROWS_PER_BLOCK)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(a.shapes, a.m, a.iters, a.rows_per_block, a.device))


if __name__ == "__main__":
    raise SystemExit(main())
