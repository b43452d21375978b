"""K1's right epilogue by its block width B: per-call device time of
``fused_decode_matmul`` on random E8P12 planes at Llama-2-7B's o, fused
qkv and fused gate/up shapes, m = 1, 8 and 32 (bf16), without the
epilogue and with right_hb of M = 8, 32, 64 (B = M) and 4096 (B = 128).
B up to a tile's 32 channels runs in the block; B = 64 and 128 take a
cluster of 2 and 4 blocks (``csrc/nibble_mma_small.cuh``). Times are
CUDA-graph replays over L2-cold plane copies (``tools/_timing.py``).
Card only:

    python -m quip_for_all_tpu_torch.tools.right_bench

The card's name and power limit first, then one JSON line per layer and m:
microseconds per call by M ("None": no epilogue).
"""
from __future__ import annotations

import json
import subprocess

import torch

from . import _timing as tm
from ..ops import fused_matmul as fm
from ..transforms.incoherence import right_hb_tensor
from ..utils.random_quantized import random_e8p_planes

SHAPES = (("o", 4096, 4096), ("qkv", 12288, 4096), ("gateup", 22016, 4096))
MS = (1, 8, 32)
RIGHT_M = (None, 8, 32, 64, 4096)
AFFINE = ((0.5, -2.75),)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("right_bench needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, q_out, q_in in SHAPES:
        w = random_e8p_planes(q_out, q_in, g, dev)
        cp = tm.cold_copies([w])
        for m in MS:
            x = torch.randn((max(8, m), 8 * w.shape[1]), generator=g,
                            device=dev).to(torch.bfloat16)
            us = {}
            for M in RIGHT_M:
                hb = None if M is None else right_hb_tensor(M, dev)
                us[str(M)] = round(tm.graph_us(
                    lambda i: fm.fused_decode_matmul(
                        x, cp[i % len(cp)], AFFINE, None, rows=m,
                        right_hb=hb), 8 * len(cp), reps=3), 2)
            print(json.dumps({"layer": name, "m": m, "us_by_M": us}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
