"""Ablations of the tensor-core kernels K2 and K3 on the card: where a slab
of their main loop spends its time, and what the accumulator flush buys.

Each variant is a copy of ``csrc/nibble_mma.cuh``,
``csrc/fused_decode_matmul_tc.cu`` (K2) and ``csrc/fused_decode_matmul_bwd.cu``
(K3) with one piece of the slab loop cut or changed, built with the port's
nvcc flags into ``build/ablate/<variant>/`` at the root of the checkout and
called through the kernels' C entry points:

  base      the sources as they are;
  nodecode  no decode of the word slab into bf16 (the MMAs read stale
            shared memory);
  norowsum  no row sums of the A slab (the beta term);
  nomma     no products (and no flush);
  noload    only the first slab is staged; the rest reuse its buffers;
  noflush   one MMA accumulator over the whole reduction, not a fresh one
            per slab added into f32 sums;
  stages2   two cp.async stages instead of three.

A cut variant computes a wrong result, so only its time is read; base,
noflush and stages2 compute the kernels' function and are held to the
plain twins (``ops/fused_matmul.py``), printing the worst ratio of error to
the tolerance (1e-5 of the max, plus one bf16 ulp for bf16 outputs). Times
are CUDA-graph replays over L2-cold plane copies (``tools/_timing.py``) at
Llama-2-7B's training shapes, m = 1022, in bf16 with one plane set, every
variant timed twice in the order given and back, and summed per LoRA step
(225 K2 calls, 222 K3 calls). Needs a card:

    python -m quip_for_all_tpu_torch.tools.ablate_mma
    python -m quip_for_all_tpu_torch.tools.ablate_mma --variants base,noflush \
        --dtypes bfloat16,float32

One JSON line per variant, shape and dtype, then one per variant with the
per-step sums; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from typing import Dict, List

import torch

from . import _timing as tm
from ..ops import _build
from ..ops import fused_matmul as fm

SOURCES = ("nibble_mma.cuh", "fused_decode_matmul_tc.cu",
           "fused_decode_matmul_bwd.cu")
KERNEL_SOURCES = SOURCES[1:]
# variant -> [(regular expression, replacement)] over the kernel sources;
# every rule must apply to each kernel source at least once
CUTS = {
    "base": [],
    "nodecode": [(r"    decode_slab<NSETS>\([^;]*\);\n", "")],
    "norowsum": [(r"    if \(!SPLIT\) stage_a<C>\([^;]*\);\n", "")],
    "nomma": [(r"    mma_slab<C, NSETS, (?:true|false)>\(\s*acc,[^;]*\);\n"
               r"    flush<C, NSETS>\(tot, acc\);\n", "")],
    "noload": [(r"    if \(next < slabs\)\n      load\(",
                "    if (false)\n      load(")],
    "noflush": [(r"(mma_slab<C, NSETS, (?:true|false)>\(\s*acc,[^;]*?dec)"
                 r"\);\n    flush<C, NSETS>\(tot, acc\);\n  \}\n",
                 r"\1, s == 0);\n  }\n"
                 r"  if (slabs > 0) flush<C, NSETS>(tot, acc);\n")],
    "stages2": [],
}
# changes to the shared header (noflush: the first product of a slab
# starts a fresh accumulator only in the first slab)
HEADER_CUTS = {
    "noflush": [(r"const __nv_bfloat16\* B\) \{",
                 "const __nv_bfloat16* B, bool fresh) {"),
                (r"if \(ks == 0 && t == 0\)",
                 "if (ks == 0 && t == 0 && fresh)")],
    "stages2": [(r"\? 3 : 2;", "? 2 : 2;")],
}
CORRECT = ("base", "noflush", "stages2")
SHAPES = [("qkvo", 4096, 4096), ("gateup", 11008, 4096),
          ("down", 4096, 11008), ("head", 32000, 4096)]
K2_CALLS = {"qkvo": 128, "gateup": 64, "down": 32, "head": 1}
K3_CALLS = {"qkvo": 125, "gateup": 64, "down": 32, "head": 1}
AFFINE = ((0.5, -2.75),)
M = 1022


def _apply(text: str, rules, where: str) -> str:
    for pattern, repl in rules:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise RuntimeError(f"ablation rule {pattern!r} found nothing in "
                               f"{where}")
    return text


def write_variant(name: str, out_dir: str) -> str:
    """The variant's three sources in out_dir/name; returns that path."""
    if name not in CUTS:
        raise ValueError(f"variant {name!r} not in {sorted(CUTS)}")
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    for f in SOURCES:
        with open(os.path.join(_build.CSRC, f)) as fh:
            text = fh.read()
        rules = HEADER_CUTS.get(name, []) if f == SOURCES[0] else CUTS[name]
        with open(os.path.join(d, f), "w") as fh:
            fh.write(_apply(text, rules, f"{name}/{f}"))
    return d


def build(names: List[str], out_dir: str) -> Dict:
    """nvcc every variant's two kernels at once; {(variant, source): fn}."""
    procs = []
    for v in names:
        d = write_variant(v, out_dir)
        for src in KERNEL_SOURCES:
            so = os.path.join(d, "lib" + src[:-3] + ".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                   os.path.join(d, src)]
            procs.append((v, src, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for v, src, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}/{src}:\n{log}")
        lib = ctypes.CDLL(so)
        if src == KERNEL_SOURCES[0]:
            fn = lib.qfa_fused_decode_matmul_tc
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_float] * 3
                           + [ctypes.c_int, ctypes.c_void_p])
        else:
            fn = lib.qfa_fused_decode_matmul_bwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float] * 3
                           + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[(v, src)] = fn
    return fns


def _k2(fn, x, w):
    q_out, Gp = w.shape
    out = torch.empty((M, q_out), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), None, None, out.data_ptr(), M,
             q_out, Gp, 1, AFFINE[0][0], 0.0, AFFINE[0][1],
             int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K2 variant launch failed: cudaError {err}")
    return out


def _k3(fn, g, w, G):
    Gn = w.shape[1]
    dx = torch.empty((M, 8 * Gn), dtype=g.dtype, device=g.device)
    err = fn(g.data_ptr(), None, w.data_ptr(), None, dx.data_ptr(), M,
             g.shape[1], Gn, G, Gn, 1, 1, AFFINE[0][0], 0.0, AFFINE[0][1],
             int(g.dtype == torch.bfloat16),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 variant launch failed: cudaError {err}")
    return dx


def err_over_tol(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over elements of |got - want| / tolerance (tools/_timing.py's)."""
    g, w = got.float(), want.float()
    tol = 1e-5 * w.abs().max()
    if got.dtype == torch.bfloat16:
        tol = tol + tm._bf16_ulp(torch.maximum(g.abs(), w.abs()))
    return float(((g - w).abs() / tol).max())


def run(variants: List[str], dtypes: List[str], seed: int = 0) -> List[Dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("the ablations need a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(variants, os.path.join(_build.BUILD_DIR, "ablate"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = variants + variants[::-1]
    recs = []
    for name, q_out, q_in in SHAPES:
        G = q_in // 8
        Gp = -(-G // 128) * 128
        w = torch.randint(-2 ** 31, 2 ** 31 - 1, (q_out, Gp), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
        cp = tm.cold_copies([w])
        for dt in dtypes:
            dtype = getattr(torch, dt)
            x = torch.zeros((M, 8, Gp), device=dev)
            x[:, :, :G] = torch.randn((M, 8, G), generator=gen, device=dev)
            x = x.reshape(M, 8 * Gp).to(dtype)
            g = torch.randn((M, q_out), generator=gen, device=dev).to(dtype)
            want2 = fm.fused_decode_matmul_ref(x, [w], AFFINE)
            want3 = fm.fused_decode_matmul_bwd_ref(g, [w], AFFINE, None, G,
                                                   Gp)
            times = {v: {"K2": [], "K3": []} for v in variants}
            for v in order:
                f2 = fns[(v, KERNEL_SOURCES[0])]
                f3 = fns[(v, KERNEL_SOURCES[1])]
                times[v]["K2"].append(tm.graph_us(
                    lambda i: _k2(f2, x, cp[i % len(cp)][0]), 4 * len(cp)))
                times[v]["K3"].append(tm.graph_us(
                    lambda i: _k3(f3, g, cp[i % len(cp)][0], G),
                    4 * len(cp)))
            for v in variants:
                rec = {"variant": v, "layer": name, "q_out": q_out,
                       "Gp": Gp, "m": M, "dtype": dt,
                       "k2_us": times[v]["K2"], "k3_us": times[v]["K3"],
                       "k2_err_over_tol": None, "k3_err_over_tol": None}
                if v in CORRECT:
                    rec["k2_err_over_tol"] = err_over_tol(
                        _k2(fns[(v, KERNEL_SOURCES[0])], x, w), want2)
                    rec["k3_err_over_tol"] = err_over_tol(
                        _k3(fns[(v, KERNEL_SOURCES[1])], g, w, G), want3)
                recs.append(rec)
                print(json.dumps(rec), flush=True)
            del x, g, want2, want3
        del cp
        torch.cuda.empty_cache()
    for v in variants:
        for dt in dtypes:
            sel = [r for r in recs if r["variant"] == v and r["dtype"] == dt]
            step = {
                "variant": v, "dtype": dt,
                "k2_ms_per_forward": sum(
                    K2_CALLS[r["layer"]] * sum(r["k2_us"]) / len(r["k2_us"])
                    for r in sel) * 1e-3,
                "k3_ms_per_step": sum(
                    K3_CALLS[r["layer"]] * sum(r["k3_us"]) / len(r["k3_us"])
                    for r in sel) * 1e-3}
            print(json.dumps(step), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(CUTS))
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    run(a.variants.split(","), a.dtypes.split(","), a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
