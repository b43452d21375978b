"""The fused/dense crossover of the prefill, by rows m. Counterpart of the
JAX package's ``tools/microbench_prefill.py``: one E8P12 layer (random
code indices from seed 0, as that tool draws them) through the two routes
of ``ops/quant_matmul.py`` ``quant_matmul``:

  fused  ``impl="fused"``: the grouped permute of x and the decode+matmul
         kernel, K1 (``csrc/fused_decode_matmul.cu``) at m <= 32, K2
         (``csrc/fused_decode_matmul_tc.cu``) above;
  dense  ``impl="dequant"``: ``ops/dequant.py`` ``decode_weights`` to a
         bf16 W, then one ``torch.matmul``.

On the card each is timed as µs a call (CUDA-graph replays, every input
L2-cold: ``_timing.graph_us`` over ``cold_copies``, as many calls as the
library product's, ``_timing._calls``) beside the bound of
the layer's function (the planes, x and the output moved once, 2 m N K
operations at the bf16 tensor-core rate) and, for the dense route, the
bound of its own traffic (W written and read back in bf16 as well); the
library call is ``x @ W.T`` on W decoded beforehand. The fused route is
held to its plain twin (1 bf16 ulp + 1e-5 of the max). It only measures:
``FUSED_MAX_M`` stays as it is. On the CPU (``--device cpu``) both routes
run (the fused one on its twin) and nothing is timed.

    python -m quip_for_all_tpu_torch.tools.microbench_prefill [--shapes 4096x4096,11008x4096,4096x11008] [--ms 8,32,128,512,1024,2048,4096,8192] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List

import numpy as np
import torch

from ..codebooks import get_codebook
from ..ops import fused_matmul as fm
from ..ops.dequant import decode_weights
from ..ops.qtensor import from_raw_idxs
from ..ops.quant_matmul import quant_matmul
from ._timing import (BF16_OPS_PER_S, HBM_BYTES_PER_S, _calls, cold_copies,
                      compare, emit, graph_us, library_us, resolve_device)

SHAPES = "4096x4096,11008x4096,4096x11008"      # N x K: q_out x q_in
MS = "8,32,128,512,1024,2048,4096,8192"
COUNTERPART = "tools/microbench_prefill.py"     # the JAX package's


def make_layer(N: int, K: int, device, seed: int = 0):
    """The JAX tool's layer: (N, K/8) random E8P12 code indices from
    ``default_rng(seed)`` as runtime planes on ``device``, and its rng
    (which draws x next)."""
    rng = np.random.default_rng(seed)
    idxs = rng.integers(0, 2 ** 16, size=(N, K // 8),
                        dtype=np.int64).astype(np.int32)
    return from_raw_idxs(get_codebook("E8P12"), idxs, N, K,
                         device=device), rng


def route(name: str):
    """The route's call x -> x @ W.T (``quant_matmul``'s impl)."""
    impl = {"fused": "fused", "dense": "dequant", "plain": "plain"}[name]
    return lambda x, qt: quant_matmul(x, qt, impl=impl)


def _with_planes(qt, planes):
    return dataclasses.replace(qt, planes=dict(zip(sorted(qt.planes),
                                                   planes)))


def _launches() -> int:
    return (fm.fused_decode_matmul.launches
            + fm.fused_decode_matmul_tc.launches)


def run_shape(N: int, K: int, ms: List[int], device="cuda") -> List[dict]:
    """One row an m: the two routes on the layer N x K (module
    docstring)."""
    dev = resolve_device(device)
    qt, rng = make_layer(N, K, dev)
    planes = qt.plane_list()
    plane_bytes = sum(p.numel() * p.element_size() for p in planes)
    W = (decode_weights(qt, dtype=torch.bfloat16)
         if dev.type == "cuda" else None)
    fused, dense, plain = route("fused"), route("dense"), route("plain")
    rows = []
    for m in ms:
        x = torch.as_tensor(rng.standard_normal((m, K)),
                            dtype=torch.bfloat16).to(dev)
        before = _launches()
        got = fused(x, qt)
        launches = _launches() - before
        want = plain(x, qt)
        dn = dense(x, qt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ok, err, rel, tol = compare(got, want)
        scale = float(dn.float().abs().max())
        io = m * K * 2 + m * N * 2
        b_bytes = (plane_bytes + io) / HBM_BYTES_PER_S * 1e6
        b_ops = 2 * m * N * K / BF16_OPS_PER_S * 1e6
        row = dict(tool="microbench_prefill", N=N, K=K, m=m,
                   kernel="K1" if m <= fm.K1_MAX_ROWS else "K2",
                   counterpart=COUNTERPART,
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                   ok=ok, max_abs_err=err, rel_err=rel, tol=tol,
                   launches=launches,
                   routes_max_abs_diff=float((got.float() - dn.float())
                                             .abs().max()),
                   routes_scale=scale,
                   bound_us=max(b_bytes, b_ops),
                   bound_by="bytes" if b_bytes >= b_ops else "operations",
                   dense_bound_us=max(
                       (plane_bytes + 4 * N * K + io) / HBM_BYTES_PER_S
                       * 1e6, b_ops),
                   fused_us=None, dense_us=None, library_us=None,
                   winner=None)
        if dev.type == "cuda":
            cp = cold_copies([x] + planes)
            qts = [(c[0], _with_planes(qt, c[1:])) for c in cp]
            n = _calls(64, len(cp))
            row["fused_us"] = graph_us(
                lambda i: fused(*qts[i % len(qts)]), n)
            row["dense_us"] = graph_us(
                lambda i: dense(*qts[i % len(qts)]), n)
            row["library_us"] = library_us(lambda a, w: a @ w.T, (x, W))
            row["winner"] = ("fused" if row["fused_us"] < row["dense_us"]
                             else "dense")
            del cp, qts
        rows.append(row)
        del x, got, want, dn
    return rows


def run(shapes: str = SHAPES, ms: str = MS, device="cuda") -> List[dict]:
    recs = []
    for s in shapes.split(","):
        N, K = (int(v) for v in s.split("x"))
        recs += run_shape(N, K, [int(v) for v in ms.split(",")], device)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=SHAPES,
                    help="N x K layers (q_out x q_in), comma-separated")
    ap.add_argument("--ms", default=MS, help="rows of x, comma-separated")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return emit(run(a.shapes, a.ms, a.device))


if __name__ == "__main__":
    raise SystemExit(main())
