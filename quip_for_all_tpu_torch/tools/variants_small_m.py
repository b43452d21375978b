"""Design variants of K1 and K11's small-m body on the card: the tile
sizes of ``csrc/nibble_mma_small.cuh`` (the tensor-core body of
``csrc/fused_decode_matmul.cu`` and ``csrc/sw_decode_matmul.cu``) timed
against each other, against the SIMT body those kernels ran before
(``csrc/nibble_decode.cuh``, which K6 still runs) and against one library
call, at Llama-2-7B's decode linears.

Each variant is a copy of the three sources with one setting changed,
built with the port's nvcc flags into ``build/variants/<variant>/`` at the
root of the checkout and called through the kernels' C entry points:

  base    the sources as they are;
  simt    the SIMT body (m tiled by at most 8 rows, f32 FMAs on the CUDA
          cores): the entry points as they were before the tensor cores;
  wn1     one channel warp a block at every m (32 channels, 8 warps over
          the slabs), not two on the widest layers above 8 rows;
  wn2     two channel warps at every m above 8 rows (64 channels, 4 warps
          over the slabs);
  mt1     16 channels a warp (one m16 tile) instead of 32;
  tiles   one block a tile of channels (a grid of all the tiles) instead
          of as many blocks as the card holds at once, each walking tiles
          with x kept in shared memory;
  warps4  4 warps a block instead of 8;
  stage32 x staged in stages of at most 32 KB (two buffers of 16 KB)
          instead of 96 KB;
  pf2     a lane's words loaded two slabs ahead instead of one.

Every variant computes the kernels' function and is held to the plain
twins (``ops/fused_matmul.py``, ``ops/layout_matmul.py``) with the ratio
of its worst error to the tolerance printed (1e-5 of the max plus one
bf16 ulp). Times are CUDA-graph replays over L2-cold plane copies
(``tools/_timing.py``) in bf16 with one plane set, every variant timed in
the order given and back, summed over a token's (m = 1, 8) or a prefill's
(m = 16, 32) 129 calls, beside the bound from the plane, x and output
bytes at 3.35 TB/s and the library call ``x @ W.T`` on bf16 weights
decoded beforehand (4x the plane bytes; the port never makes it). Needs
a card:

    python -m quip_for_all_tpu_torch.tools.variants_small_m
    python -m quip_for_all_tpu_torch.tools.variants_small_m \
        --variants base,simt --m 1,32 --layouts nibble,sw4

One JSON line per variant, layout, shape and m, then one per variant,
layout and m with the sums; the card's name and power limit first. With
``--prefill``, then one line per variant with the device ms of
Llama-2-7B's 32-token prefill (chip_smoke.py's main path) run on that
variant's K1.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time
from typing import Dict, List

import torch

from . import _timing as tm
from ..ops import _build
from ..ops import fused_matmul as fm
from ..ops import layout_matmul as lm
from ..ops.dequant import decode_weights
from ..ops.qtensor import QuantizedTensor, to_subword

HEADER = "nibble_mma_small.cuh"
ENTRIES = {"nibble": "fused_decode_matmul", "sw2": "sw_decode_matmul",
           "sw4": "sw_decode_matmul"}
SOURCES = (HEADER, "fused_decode_matmul.cu", "sw_decode_matmul.cu")
# variant -> [(regular expression, replacement)] over the header; every
# rule must apply at least once
RULES = {
    "base": [],
    "simt": [],
    "wn1": [(r"const bool wide = [^;]*;", "const bool wide = false;")],
    "wn2": [(r"const bool wide = [^;]*;", "const bool wide = true;")],
    "mt1": [(r"constexpr int MT = 2;", "constexpr int MT = 1;")],
    "tiles": [(r"ntiles < resident_blocks \? ntiles : resident_blocks",
               "ntiles")],
    "warps4": [(r"constexpr int THREADS = 256;",
                "constexpr int THREADS = 128;")],
    "stage32": [(r"STAGE_BUDGET = 96 \* 1024;", "STAGE_BUDGET = 32 * 1024;")],
    "pf2": [(r"constexpr int PF = 1;", "constexpr int PF = 2;")],
}
# the simt variant's entry points: the SIMT body's dispatch
SIMT_ENTRY = {
    "fused_decode_matmul.cu": '''#include "nibble_decode.cuh"
extern "C" int qfa_fused_decode_matmul(const void* x, const void* w0,
    const void* w1, const void* scale, void* out, int m, int q_out, int Gp,
    int n_sets, float alpha0, float alpha1, float beta_total, int x_is_bf16,
    void* stream) {
  const NibbleArgs a{x, w0, w1, scale, out, nullptr, m, q_out, Gp, 1,
                     alpha0, alpha1, beta_total};
  return dispatch<1, false>(a, n_sets, x_is_bf16, stream);
}
''',
    "sw_decode_matmul.cu": '''#include "nibble_decode.cuh"
extern "C" int qfa_sw_decode_matmul(const void* x, const void* w0,
    const void* w1, const void* scale, void* out, int m, int q_out, int Gp,
    int n_sets, float alpha0, float alpha1, float beta_total, int x_is_bf16,
    int split, void* stream) {
  const NibbleArgs a{x, w0, w1, scale, out, nullptr, m, q_out, Gp, 1,
                     alpha0, alpha1, beta_total};
  if (split == 2) return dispatch<2, false>(a, n_sets, x_is_bf16, stream);
  if (split == 4) return dispatch<4, false>(a, n_sets, x_is_bf16, stream);
  return 11;
}
'''}
# Llama-2-7B's decode linears (fused qkv and gate/up, quantized head) and
# their calls a token or a prefill
SHAPES = [("qkv", 12288, 4096), ("o", 4096, 4096), ("gateup", 22016, 4096),
          ("down", 4096, 11008), ("head", 32000, 4096)]
CALLS = {"qkv": 32, "o": 32, "gateup": 32, "down": 32, "head": 1}
AFFINE = ((0.5, -2.75),)


def _apply(text: str, rules, where: str) -> str:
    for pattern, repl in rules:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise RuntimeError(f"variant rule {pattern!r} found nothing in "
                               f"{where}")
    return text


def write_variant(name: str, out_dir: str) -> str:
    """The variant's sources (and the headers they include) in
    out_dir/name; returns that path."""
    if name not in RULES:
        raise ValueError(f"variant {name!r} not in {sorted(RULES)}")
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    for f in sorted(os.listdir(_build.CSRC)):
        if not f.endswith(".cuh") and f not in SOURCES:
            continue
        with open(os.path.join(_build.CSRC, f)) as fh:
            text = fh.read()
        if f == HEADER:
            text = _apply(text, RULES[name], f"{name}/{f}")
        elif name == "simt" and f in SIMT_ENTRY:
            text = SIMT_ENTRY[f]
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build(names: List[str], out_dir: str) -> Dict:
    """nvcc every variant's two entry sources at once;
    {(variant, source stem): loaded library}."""
    procs = []
    for v in names:
        d = write_variant(v, out_dir)
        for src in SOURCES[1:]:
            so = os.path.join(d, "lib" + src[:-3] + ".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                   os.path.join(d, src)]
            procs.append((v, src[:-3], so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for v, stem, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}/{stem}.cu:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        # each instantiation: template arguments (mangled) and registers
        per_fn = re.findall(r"Function properties for (\S+)\n.*?"
                            r"(\d+) bytes spill stores.*?\n.*?Used (\d+) "
                            r"registers", log, re.S)
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and not re.search(
                             r"\b0 bytes spill stores, 0 bytes spill loads",
                             ln)})
        print(json.dumps({"variant": v, "source": stem + ".cu",
                          "max_registers": max(regs, default=None),
                          "spills": spills,
                          "kernels": [(re.sub(r".*kernelI(.+?)EEv.*", r"\1",
                                              f), int(r), int(sp))
                                      for f, sp, r in per_fn]}), flush=True)
        fns[(v, stem)] = ctypes.CDLL(so)
    return fns


def entry(lib, stem: str):
    """The C entry point of a variant's library, its types set."""
    fn = getattr(lib, "qfa_" + stem)
    extra = 1 if stem == "sw_decode_matmul" else 0
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * (1 + extra)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(fn, layout, x, w, m):
    """One launch of a variant's entry on words w (q_out, Gp) int32."""
    q_out, Gp = w.shape
    out = torch.empty((m, q_out), dtype=x.dtype, device=x.device)
    extra = () if layout == "nibble" else (int(layout[2]),)
    err = fn(x.data_ptr(), w.data_ptr(), None, None, out.data_ptr(), m,
             q_out, Gp, 1, AFFINE[0][0], 0.0, AFFINE[0][1],
             int(x.dtype == torch.bfloat16), *extra,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{layout} variant launch failed: cudaError {err}")
    return out


def err_over_tol(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over elements of |got - want| / tolerance (tools/_timing.py's)."""
    g, w = got.float(), want.float()
    tol = 1e-5 * w.abs().max()
    if got.dtype == torch.bfloat16:
        tol = tol + tm._bf16_ulp(torch.maximum(g.abs(), w.abs()))
    return float(((g - w).abs() / tol).max())


def run(variants: List[str], ms: List[int], layouts: List[str],
        seed: int = 0, prefill: bool = False) -> List[Dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("the variants need a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    libs = build(variants, os.path.join(_build.BUILD_DIR, "variants"))
    print(json.dumps({"build_s": time.time() - t0}), flush=True)
    fns = {k: entry(lib, k[1]) for k, lib in libs.items()}
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
        W = decode_weights(QuantizedTensor({"w0": w}, "E8P12", q_out, q_in),
                           dtype=torch.bfloat16)
        Wc = tm.cold_copies([W])
        for m in ms:
            x_nat = torch.randn((m, q_in), generator=gen, device=dev).to(
                torch.bfloat16)
            lib_us = tm.graph_us(lambda i: torch.matmul(
                x_nat, Wc[i % len(Wc)][0].T), 4 * len(Wc))
            for layout in layouts:
                P = 1 if layout == "nibble" else int(layout[2])
                x = fm.grouped_permute(x_nat, Gp, P).contiguous()
                if layout == "nibble":
                    want = fm.fused_decode_matmul_ref(x, [w], AFFINE)
                else:
                    sw = to_subword(QuantizedTensor({"w0": w}, "E8P12", q_out,
                                                    q_in), P).plane_list()
                    want = lm.sw_decode_matmul_ref(x, sw, AFFINE)
                stem = ENTRIES[layout]
                times = {v: [] for v in variants}
                for v in order:
                    f = fns[(v, stem)]
                    times[v].append(tm.graph_us(
                        lambda i: _call(f, layout, x, cp[i % len(cp)][0], m),
                        4 * len(cp)))
                nbytes = w.numel() * 4 + x.numel() * 2 + m * q_out * 2
                for v in variants:
                    rec = {"variant": v, "layout": layout, "layer": name,
                           "q_out": q_out, "Gp": Gp, "m": m,
                           "us": times[v],
                           "bound_us": nbytes / tm.HBM_BYTES_PER_S * 1e6,
                           "library_us": lib_us,
                           "err_over_tol": err_over_tol(
                               _call(fns[(v, stem)], layout, x, w, m), want)}
                    recs.append(rec)
                    print(json.dumps(rec), flush=True)
        del cp, W, Wc
        torch.cuda.empty_cache()
    for v in variants:
        for layout in layouts:
            for m in ms:
                sel = [r for r in recs if r["variant"] == v
                       and r["layout"] == layout and r["m"] == m]
                tot = {k: sum(CALLS[r["layer"]] * (sum(r[k]) / len(r[k])
                                                    if k == "us" else r[k])
                              for r in sel) * 1e-3
                       for k in ("us", "bound_us", "library_us")}
                print(json.dumps({
                    "variant": v, "layout": layout, "m": m,
                    "per": "token" if m <= 8 else "prefill",
                    "ms": tot["us"], "bound_ms": tot["bound_us"],
                    "library_ms": tot["library_us"],
                    "worst_err_over_tol": max(r["err_over_tol"]
                                              for r in sel)}), flush=True)
    if prefill:
        prefill_ms(variants, libs, seed)
    return recs


def prefill_ms(variants: List[str], libs: Dict, seed: int = 0,
               S: int = 32, reps: int = 10) -> Dict:
    """Device ms of Llama-2-7B E8P12's S-token bf16 prefill (random codes
    from ``seed``, fused qkv and gate/up, quantized head, the main path of
    chip_smoke.py) with each variant's K1 in place of the built one: the
    prefill captured in a CUDA graph and replayed ``reps`` times, every
    variant in the order given and back. The 129 linears must launch K1
    (fused_decode_matmul.launches counts them)."""
    import quip_for_all_tpu_torch as qt
    from ..models import llama as M
    from ..runtime.generate import attn_bucket, init_kv_caches
    cfg = qt.llama2_7b_config()
    model = qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, seed=seed, dtype=torch.bfloat16, quantize_head=True,
        device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    caches = init_kv_caches(cfg, 1, 2048, torch.bfloat16, "cuda")
    window = attn_bucket(S, 2048)

    def step(_):
        return M.model_apply(cfg, model, prompt, kv_caches=caches,
                             cache_position=0, dtype=torch.bfloat16,
                             attn_window=window)[0]
    times = {v: [] for v in variants}
    try:
        for v in variants + variants[::-1]:
            _build._libs["fused_decode_matmul"] = libs[
                (v, "fused_decode_matmul")]
            before = fm.fused_decode_matmul.launches
            step(0)
            torch.cuda.synchronize()
            if fm.fused_decode_matmul.launches - before != 4 * 32 + 1:
                raise RuntimeError("the prefill did not run K1 129 times")
            times[v].append(1e-3 * tm.graph_us(step, 1, reps=reps))
    finally:
        _build._libs.pop("fused_decode_matmul", None)
    for v in variants:
        print(json.dumps({"variant": v, "prefill_tokens": S,
                          "prefill_device_ms": times[v]}), flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(RULES))
    ap.add_argument("--m", default="1,8,16,32")
    ap.add_argument("--layouts", default="nibble,sw4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", action="store_true",
                    help="also time Llama-2-7B's 32-token prefill with "
                         "each variant's K1")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    run(a.variants.split(","), [int(v) for v in a.m.split(",")],
        a.layouts.split(","), a.seed, a.prefill)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
