"""T3: the nibble decode from int32, int16 or int8 views of one plane
(split P = 1, 2, 4). Counterpart of the JAX package's
``tools/microbench_split.py`` (``make_call`` at :48, its ``pallas_call`` at
:74). Its function is the port's K1 at P = 1 (``csrc/fused_decode_matmul.cu``)
and K11 at P = 2, 4 (``csrc/sw_decode_matmul.cu``, on the int16 / int8
views of the same words), each with the E8P affine (0.5, -2.75) and no
scale vector: out = 0.5 * (x . nib) - 2.75 * rowsum(x), bf16, with x in
the lane layout of split P (``x_layout``: x[8g + nq*j + q] at lane
q*(P*Gp) + P*g + j, nq = 8/P; the lane order of
``csrc/nibble_decode.cuh``). This module calls those kernels through their
wrappers; it has no kernel of its own.

    python -m quip_for_all_tpu_torch.tools.microbench_split --shapes 4096x4096 --m 8
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from ..ops import fused_matmul as fm
from ..ops import layout_matmul as lm
from ._timing import (BF16_OPS_PER_S, emit, measure, product_us,
                      resolve_device)
from .microbench_tn import decoded

ALPHA, BETA = 0.5, -2.75
AFFINE = ((ALPHA, BETA),)
SPLITS = (1, 2, 4)
VIEW = {1: torch.int32, 2: torch.int16, 4: torch.int8}
REPLACES = "tools/microbench_split.py:74"
SOURCE = {1: "quip_for_all_tpu_torch/csrc/fused_decode_matmul.cu",
          2: "quip_for_all_tpu_torch/csrc/sw_decode_matmul.cu",
          4: "quip_for_all_tpu_torch/csrc/sw_decode_matmul.cu"}


def x_layout(x_nat: torch.Tensor, P: int, G: int, Gp: int) -> torch.Tensor:
    """natural (m, 8G) -> the lane layout of split P (m, 8*Gp), pad lanes
    zero."""
    m, nq = x_nat.shape[0], 8 // P
    xg = x_nat.reshape(m, G, P, nq).permute(0, 3, 1, 2)       # (m, nq, G, P)
    xg = torch.nn.functional.pad(xg, (0, 0, 0, Gp - G))
    return xg.reshape(m, 8 * Gp).contiguous()


def wrapper(P: int):
    """The kernel wrapper split P runs (its ``.launches`` counts)."""
    return fm.fused_decode_matmul if P == 1 else lm.sw_decode_matmul


def split_call(P: int, x_perm: torch.Tensor, words: torch.Tensor
               ) -> torch.Tensor:
    """Split P on the (q_out, Gp) int32 words: K1 (P = 1) or K11 on their
    int16 / int8 view."""
    return wrapper(P)(x_perm, [words.view(VIEW[P])], AFFINE)


def split_ref(P: int, x_perm: torch.Tensor, words: torch.Tensor
              ) -> torch.Tensor:
    twin = (fm.fused_decode_matmul_ref if P == 1
            else lm.sw_decode_matmul_ref)
    return twin(x_perm, [words.view(VIEW[P])], AFFINE)


def make_inputs(N: int, K: int, m: int, device, seed: int = 0):
    """The JAX tool's inputs: random 32-bit words (N, Gp), x_nat
    ~ N(0, 1/K) (m, K) f32."""
    rng = np.random.default_rng(seed)
    G = K // 8
    Gp = -(-G // 128) * 128
    words = rng.integers(0, 1 << 32, size=(N, Gp),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    x_nat = (rng.standard_normal((m, K)) / np.sqrt(K)).astype(np.float32)
    return (torch.from_numpy(x_nat).to(device),
            torch.from_numpy(words).to(device))


def run(shapes: str = "4096x4096", m: int = 8, iters: int = 64,
        device="cuda") -> List[dict]:
    dev = resolve_device(device)
    recs = []
    for s in shapes.split(","):
        N, K = (int(v) for v in s.split("x"))
        x_nat, words = make_inputs(N, K, m, dev)
        G, Gp = K // 8, words.shape[1]
        lib = product_us(decoded(words), m)
        for P in SPLITS:
            xp = x_layout(x_nat, P, G, Gp).to(torch.bfloat16)
            recs.append(measure(
                lambda a, b, P=P: split_call(P, a, b),
                lambda a, b, P=P: split_ref(P, a, b), (xp, words),
                wrapper(P), nbytes=N * Gp * 4 + m * 8 * Gp * 2 + m * N * 2,
                ops=2 * m * N * 8 * Gp, ops_per_s=BF16_OPS_PER_S,
                iters=iters, tool="microbench_split", variant=f"P{P}",
                kernel=wrapper(P).__name__, source=SOURCE[P],
                replaces=REPLACES, N=N, K=K, m=m, library_us=lib))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="4096x4096")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(a.shapes, a.m, a.iters, a.device))


if __name__ == "__main__":
    raise SystemExit(main())
