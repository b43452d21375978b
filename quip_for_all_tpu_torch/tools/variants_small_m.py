"""Design variants of the small-m tensor-core body on the card: the tile
sizes of ``csrc/nibble_mma_small.cuh`` (the body of K1,
``csrc/fused_decode_matmul.cu``, K11, ``csrc/sw_decode_matmul.cu``,
split-K K6, ``csrc/ksplit_decode_matmul.cu``, bfp K10,
``csrc/bfp_decode_matmul.cu``, and the MoE kernel K4/K5,
``csrc/moe_decode_matmul.cu``, and with the u-code policies of
``csrc/ucode_mma_small.cuh`` the body of K8's pb and K9's u3 entries,
``csrc/rowpair_decode_matmul.cu``, and K7, ``csrc/paired_decode_matmul.cu``)
timed against each other, against the SIMT body K1 and K11 ran before
(``csrc/nibble_decode.cuh``), against the sources of another checkout and
against one library call, at Llama-2-7B's decode linears (the MoE kernel
at Mixtral-8x7B's expert linears).

Each variant is a copy of the sources with one setting changed, built
with the port's nvcc flags into ``build/variants/<variant>/`` at the root
of the checkout and called through the kernels' C entry points:

  base    the sources as they are;
  parent  the csrc directory given by ``--parent`` as it is (for example
          another commit's, unpacked with ``git archive``), whose entry
          points take the same arguments;
  simt    (nibble, sw2, sw4) the SIMT body (m tiled by at most 8 rows, f32
          FMAs on the CUDA cores): the entry points as they were before
          the tensor cores;
  wn1     one channel warp a block at every m (32 channels, 8 warps over
          the slabs), not two on the widest layers above 8 rows;
  wn2     two channel warps at every m above 8 rows (64 channels, 4 warps
          over the slabs);
  mt1     16 channels a warp (one m16 tile) instead of 32 (u3 too: 16 at
          every row count);
  tiles   one block a unit of work (a tile of channels, split-K: a tile's
          chunk; a grid of all of them) instead of as many blocks as the
          card holds at once, each walking units with x kept in shared
          memory;
  warps4  4 warps a block instead of 8;
  stage32 x staged in stages of at most 32 KB (two buffers of 16 KB)
          instead of 96 KB;
  pf2     a lane's words loaded two slabs ahead instead of one;
  pf0     no words loaded ahead;
  occ2    at one n8 tile of rows, registers capped for two blocks an SM;
  nofuse  (pb, paired) a pass a set at one n8 tile of rows too;
  umt2    (pb, paired) two m16 tiles a warp at one n8 tile of rows too.

The layouts: nibble (K1), sw2 and sw4 (K11), ksplit4 (K6 on nibble words:
4 chunks, 11 at down's 1408 groups, as chip_smoke.py runs it; its sums
leave down out, as path (f) does), bfp (K10), pb (K8), paired (K7), u3
(K9), and moe (K4/K5 at Mixtral-8x7B's w13 and w2 with 8 experts, top-2
rows of R/2 tokens with the bound R/2, R = 2, 16 and 62 whatever --m
says; summed over a step's 64 calls). Every variant computes the kernels'
function and is held to the plain twins (``ops/fused_matmul.py``,
``ops/layout_matmul.py``, ``ops/rowpair_matmul.py``,
``ops/moe_matmul.py``) with the ratio of its worst error to the tolerance
printed (1e-5 of the max plus one bf16 ulp). The nibble layouts run one
plane set of random words, pb and paired random E8P12RVQ4B codes, u3
random E8P12 codes.
Times are CUDA-graph replays over L2-cold plane copies
(``tools/_timing.py``) in bf16, every variant timed in the order given and
back, summed over a token's (m = 1, 8) or a prefill's (m = 16, 32) 129
calls (split-K: 97, and every layout's sum without down as well), beside
the bound from the plane, x and output bytes at 3.35 TB/s and the library
call ``x @ W.T`` on bf16 weights decoded beforehand (the port never makes
it). Needs a card:

    python -m quip_for_all_tpu_torch.tools.variants_small_m
    python -m quip_for_all_tpu_torch.tools.variants_small_m \
        --variants base,simt --m 1,32 --layouts nibble,sw4
    git archive <commit> quip_for_all_tpu_torch/csrc | tar -x -C build/parent
    python -m quip_for_all_tpu_torch.tools.variants_small_m \
        --variants parent,base --parent $PWD/build/parent/quip_for_all_tpu_torch/csrc \
        --layouts u3,ksplit4 --m 1,8,32 --prefill

One JSON line per variant, layout, shape and m, then one per variant,
layout and m with the sums; the card's name and power limit first. With
``--prefill``, then one line per variant and layout family with the
device ms of Llama-2-7B's 32-token prefill (chip_smoke.py's paths: the
main path's E8P12 nibble for nibble/sw, E8P12 bfp, E8P12RVQ4B pb or
paired, E8P12 u3) run on that variant's kernel, and for moe Mixtral-8x7B's
16-token sparse prefill (R = 32 rows a call, the bound 16).
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
from ..ops import rowpair_matmul as rm
from ..ops.dequant import decode_weights
from ..ops import moe_matmul as mm
from ..ops.qtensor import QuantizedTensor, to_bfp, to_subword
from ..utils.random_quantized import random_qtensor

HEADER = "nibble_mma_small.cuh"
# the sources the rules edit (each rule must apply in one of them)
RULE_HEADERS = (HEADER, "ucode_mma_small.cuh")
# layout -> (source stem, C entry point)
ENTRIES = {"nibble": ("fused_decode_matmul", "qfa_fused_decode_matmul"),
           "sw2": ("sw_decode_matmul", "qfa_sw_decode_matmul"),
           "sw4": ("sw_decode_matmul", "qfa_sw_decode_matmul"),
           "pb": ("rowpair_decode_matmul", "qfa_rowpair_pb_matmul"),
           "paired": ("paired_decode_matmul", "qfa_paired_decode_matmul"),
           "u3": ("rowpair_decode_matmul", "qfa_rowpair_u3_matmul"),
           "ksplit4": ("ksplit_decode_matmul", "qfa_ksplit_decode_matmul"),
           "bfp": ("bfp_decode_matmul", "qfa_bfp_decode_matmul"),
           "moe": ("moe_decode_matmul", "qfa_moe_decode_matmul")}
UCODE = ("pb", "paired", "u3")
# the layouts the simt variant has a body for
SIMT_LAYOUTS = ("nibble", "sw2", "sw4")
SOURCES = (HEADER, "fused_decode_matmul.cu", "sw_decode_matmul.cu")
UCODE_SOURCES = ("rowpair_decode_matmul.cu", "paired_decode_matmul.cu")
KSPLIT_SOURCE = "ksplit_decode_matmul.cu"
# the sources of K10 and K4/K5, on the same body
ROWMAP_SOURCES = ("bfp_decode_matmul.cu", "moe_decode_matmul.cu")
# variant -> [(regular expression, replacement)] over the rule sources;
# every rule must apply at least once
RULES = {
    "base": [],
    "simt": [],
    "wn1": [(r"const bool wide = [^;]*;", "const bool wide = false;")],
    "wn2": [(r"const bool wide = [^;]*;", "const bool wide = true;")],
    "mt1": [(r"constexpr int MT = 2;", "constexpr int MT = 1;")],
    "tiles": [(r"ntiles \* nch < resident_blocks \? ntiles \* nch\s*"
               r": resident_blocks", "ntiles * nch")],
    "warps4": [(r"constexpr int THREADS = 256;",
                "constexpr int THREADS = 128;")],
    "stage32": [(r"STAGE_BUDGET = 96 \* 1024;", "STAGE_BUDGET = 32 * 1024;")],
    "pf2": [(r"constexpr int PF = 1;", "constexpr int PF = 2;")],
    "pf0": [(r"constexpr int PF = 1;", "constexpr int PF = 0;")],
    "occ2": [(r"__launch_bounds__\(THREADS\)\nmma_small_kernel",
              "__launch_bounds__(THREADS, NT == 1 ? 2 : 1)\nmma_small_kernel")],
    "nofuse": [(r"bool fused\(int nt\) \{ return nt == 1; \}",
                "bool fused(int nt) { return false; }")],
    "umt2": [(r"return nt == 1 \? 1 : MT;", "return MT;")],
}
# the simt variant's entry points (the nibble layouts): the SIMT body's
# dispatch
SIMT_ENTRY = {
    "fused_decode_matmul.cu": '''#include "nibble_decode.cuh"
extern "C" int qfa_fused_decode_matmul(const void* x, const void* w0,
    const void* w1, const void* scale, void* out, int m, int q_out, int Gp,
    int n_sets, float alpha0, float alpha1, float beta_total, int x_is_bf16,
    void* stream) {
  const NibbleArgs a{x, w0, w1, scale, out, m, q_out, Gp, alpha0, alpha1,
                     beta_total};
  return dispatch<1>(a, n_sets, x_is_bf16, stream);
}
''',
    "sw_decode_matmul.cu": '''#include "nibble_decode.cuh"
extern "C" int qfa_sw_decode_matmul(const void* x, const void* w0,
    const void* w1, const void* scale, void* out, int m, int q_out, int Gp,
    int n_sets, float alpha0, float alpha1, float beta_total, int x_is_bf16,
    int split, void* stream) {
  const NibbleArgs a{x, w0, w1, scale, out, m, q_out, Gp, alpha0, alpha1,
                     beta_total};
  if (split == 2) return dispatch<2>(a, n_sets, x_is_bf16, stream);
  if (split == 4) return dispatch<4>(a, n_sets, x_is_bf16, stream);
  return 11;
}
'''}
# Llama-2-7B's decode linears (fused qkv and gate/up, quantized head) and
# their calls a token or a prefill
SHAPES = [("qkv", 12288, 4096), ("o", 4096, 4096), ("gateup", 22016, 4096),
          ("down", 4096, 11008), ("head", 32000, 4096)]
CALLS = {"qkv": 32, "o": 32, "gateup": 32, "down": 32, "head": 1}
# path (f): down's 11 lane blocks do not split 4 ways, so it stays on K1
KSPLIT_CALLS = {k: v for k, v in CALLS.items() if k != "down"}
# Mixtral-8x7B's stacked experts (w1/w3 fused, w2) and their calls a step
MOE_SHAPES = [("w13", 28672, 4096), ("w2", 4096, 14336)]
MOE_CALLS = {"w13": 32, "w2": 32}
MOE_E, MOE_R = 8, (2, 16, 62)
AFFINE = ((0.5, -2.75),)


def _apply(texts: Dict[str, str], rules, where: str) -> Dict[str, str]:
    """Each rule over every text; it must change at least one."""
    texts = dict(texts)
    for pattern, repl in rules:
        found = 0
        for f in texts:
            texts[f], n = re.subn(pattern, repl, texts[f])
            found += n
        if found == 0:
            raise RuntimeError(f"variant rule {pattern!r} found nothing in "
                               f"{where}")
    return texts


def write_variant(name: str, out_dir: str, parent: str = None) -> str:
    """The variant's sources (and the headers they include) in
    out_dir/name; returns that path. The ``parent`` variant copies the
    csrc directory ``parent`` as it is."""
    if name not in RULES and name != "parent":
        raise ValueError(f"variant {name!r} not in "
                         f"{sorted(RULES) + ['parent']}")
    if name == "parent" and not parent:
        raise ValueError("the parent variant needs --parent <csrc dir>")
    src = parent if name == "parent" else _build.CSRC
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    texts = {}
    for f in sorted(os.listdir(src)):
        if f.endswith(".cuh") or f in SOURCES + UCODE_SOURCES + (
                KSPLIT_SOURCE,) + ROWMAP_SOURCES:
            with open(os.path.join(src, f)) as fh:
                texts[f] = fh.read()
    if name != "parent":
        texts.update(_apply({f: texts[f] for f in RULE_HEADERS}, RULES[name],
                            f"{name}/{'+'.join(RULE_HEADERS)}"))
    if name == "simt":
        texts.update(SIMT_ENTRY)
    for f, text in texts.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build(names: List[str], out_dir: str, stems: List[str],
          parent: str = None) -> Dict:
    """nvcc every variant's entry sources of ``stems`` at once;
    {(variant, source stem): loaded library}."""
    procs = []
    for v in names:
        d = write_variant(v, out_dir, parent)
        for src in (f + ".cu" for f in stems):
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


def entry(lib, layout: str):
    """The C entry point of a variant's library for a layout, its types
    set."""
    fn = getattr(lib, ENTRIES[layout][1])
    if layout == "moe":
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
    elif layout == "ksplit4":
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    elif layout in UCODE:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    else:
        extra = 0 if layout in ("nibble", "bfp") else 1
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * (1 + extra)
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(fn, layout, x, w, m, rs=-1.0, chunks=1):
    """One call of a variant's entry on words w (q_out, Gp) int32 (split
    into ``chunks`` for ksplit4), or on a u-code layout's planes {w0, w1,
    w2} with residual scale rs."""
    if layout in UCODE:
        q_out = w["w2"].shape[0] * (1 if layout == "paired" else 2)
        out = torch.empty((m, q_out), dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), w["w0"].data_ptr(), w["w1"].data_ptr(),
                 w["w2"].data_ptr(), None, out.data_ptr(), m, q_out,
                 w["w0"].shape[-1], w["w2"].shape[-1], rs,
                 2.25 if layout == "u3" else 2.25 * (1 + rs),
                 int(rm.group_sum_in_bf16(x)),
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{layout} variant launch failed: cudaError "
                               f"{err}")
        return out
    # bfp planes (2, q_out/2, Gp)
    q_out, Gp = ((2 * w.shape[1], w.shape[2]) if layout == "bfp"
                 else w.shape)
    out = torch.empty((m, q_out), dtype=x.dtype, device=x.device)
    if layout == "ksplit4":
        ws = torch.empty(chunks * m * q_out, dtype=torch.float32,
                         device=x.device)
        err = fn(x.data_ptr(), w.data_ptr(), None, None, ws.data_ptr(),
                 out.data_ptr(), m, q_out, Gp, 1, AFFINE[0][0], 0.0,
                 AFFINE[0][1], int(x.dtype == torch.bfloat16), chunks,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ksplit4 variant launch failed: cudaError "
                               f"{err}")
        return out
    extra = () if layout in ("nibble", "bfp") else (int(layout[2]),)
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


def _case(layout: str, q_out: int, q_in: int, gen, dev):
    """(words or planes, their L2-cold copies, plane bytes, the bf16 weights
    of the library call, P, rs, chunks, twin(x) on the first copy) of one
    layer: random words for the nibble layouts (one plane set), random
    E8P12RVQ4B codes for pb and paired, random E8P12 codes for u3."""
    if layout in UCODE:
        qt = random_qtensor("E8P12" if layout == "u3" else "E8P12RVQ4B",
                            layout, q_out, q_in, gen, dev)
        planes, rs = qt.planes, qt.opt_resid_scale
        return (planes, tm.cold_copies(planes),
                sum(v.numel() * 4 for v in planes.values()),
                decode_weights(qt, dtype=torch.bfloat16), 1, rs, 1,
                lambda x, m: rm.rowpair_matmul_ref(x, layout, planes, rs,
                                                   rows=m))
    Gp = -(-(q_in // 8) // 128) * 128
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (q_out, Gp), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    qt = QuantizedTensor({"w0": w}, "E8P12", q_out, q_in)
    P = 1 if layout in ("nibble", "ksplit4", "bfp") else int(layout[2])
    # split-K: 4 chunks, or 11 where 4 do not split the 128-group blocks
    chunks = 1
    if layout == "ksplit4":
        chunks = lm.pick_ksplit(4, Gp) if lm.pick_ksplit(4, Gp) > 1 else \
            lm.pick_ksplit(11, Gp)
        twin = lambda x, m: lm.ksplit_decode_matmul_ref(x[:m], [w], AFFINE,
                                                        chunks)
    elif layout == "bfp":
        w3 = to_bfp(qt).planes["w0"]
        return (w3, [c[0] for c in tm.cold_copies([w3])], w3.numel() * 4,
                decode_weights(qt, dtype=torch.bfloat16), 1, -1.0, 1,
                lambda x, m: lm.bfp_decode_matmul_ref(x[:m], [w3], AFFINE))
    elif P == 1:
        twin = lambda x, m: fm.fused_decode_matmul_ref(x[:m], [w], AFFINE)
    else:
        sw = to_subword(qt, P).plane_list()
        twin = lambda x, m: lm.sw_decode_matmul_ref(x[:m], sw, AFFINE)
    return (w, [c[0] for c in tm.cold_copies([w])], w.numel() * 4,
            decode_weights(qt, dtype=torch.bfloat16), P, -1.0, chunks, twin)


def run(variants: List[str], ms: List[int], layouts: List[str],
        seed: int = 0, prefill: bool = False,
        parent: str = None) -> List[Dict]:
    if "simt" in variants and any(lay not in SIMT_LAYOUTS
                                  for lay in layouts):
        raise ValueError("the simt variant is the nibble layouts' SIMT "
                         "body; time the SIMT bodies of pb, paired, u3 and "
                         "split-K as the parent variant of a commit that "
                         "ran them")
    if not torch.cuda.is_available():
        raise RuntimeError("the variants need a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    stems = sorted({ENTRIES[lay][0] for lay in layouts})
    libs = build(variants, os.path.join(_build.BUILD_DIR, "variants"), stems,
                 parent)
    print(json.dumps({"build_s": time.time() - t0}), flush=True)
    fns = {(v, lay): entry(libs[(v, ENTRIES[lay][0])], lay)
           for v in variants for lay in layouts}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    order = variants + variants[::-1]
    recs = []
    llama = [lay for lay in layouts if lay != "moe"]
    for name, q_out, q_in in SHAPES:
        for layout in llama:
            w, cp, plane_bytes, W, P, rs, chunks, twin = _case(
                layout, q_out, q_in, gen, dev)
            Gp = (w["w0"] if layout in UCODE else w).shape[-1]
            Wc = tm.cold_copies([W])
            for m in ms:
                x_nat = torch.randn((m, q_in), generator=gen, device=dev).to(
                    torch.bfloat16)
                lib_us = tm.graph_us(lambda i: torch.matmul(
                    x_nat, Wc[i % len(Wc)][0].T), 4 * len(Wc))
                x = fm.grouped_permute(x_nat, Gp, P).contiguous()
                want = twin(x, m)
                times = {v: [] for v in variants}
                for v in order:
                    f = fns[(v, layout)]
                    times[v].append(tm.graph_us(
                        lambda i: _call(f, layout, x, cp[i % len(cp)], m, rs,
                                        chunks),
                        4 * len(cp)))
                nbytes = plane_bytes + x.numel() * 2 + m * q_out * 2
                for v in variants:
                    rec = {"variant": v, "layout": layout, "layer": name,
                           "q_out": q_out, "Gp": Gp, "m": m,
                           "chunks": chunks, "us": times[v],
                           "bound_us": nbytes / tm.HBM_BYTES_PER_S * 1e6,
                           "library_us": lib_us,
                           "err_over_tol": err_over_tol(
                               _call(fns[(v, layout)], layout, x, w, m, rs,
                                     chunks), want)}
                    recs.append(rec)
                    print(json.dumps(rec), flush=True)
            del w, cp, W, Wc
            torch.cuda.empty_cache()
    for v in variants:
        for layout in llama:
            for m in ms:
                sel = [r for r in recs if r["variant"] == v
                       and r["layout"] == layout and r["m"] == m]

                def tot(k, calls):
                    return sum(calls.get(r["layer"], 0) * (
                        sum(r[k]) / len(r[k]) if k == "us" else r[k])
                        for r in sel) * 1e-3
                calls = KSPLIT_CALLS if layout == "ksplit4" else CALLS
                print(json.dumps({
                    "variant": v, "layout": layout, "m": m,
                    "per": "token" if m <= 8 else "prefill",
                    "calls": sum(calls.values()),
                    "ms": tot("us", calls), "bound_ms": tot("bound_us", calls),
                    "library_ms": tot("library_us", calls),
                    "ms_no_down": tot("us", KSPLIT_CALLS),
                    "worst_err_over_tol": max(r["err_over_tol"]
                                              for r in sel)}), flush=True)
    if "moe" in layouts:
        recs += run_moe(variants, {v: fns[(v, "moe")] for v in variants},
                        gen)
    if prefill:
        for layout in ([lay for lay in layouts if lay in UCODE]
                       + [lay for lay in ("nibble", "bfp")
                          if lay in layouts]):
            prefill_ms(variants, libs, seed, layout=layout)
        if "moe" in layouts:
            mixtral_prefill_ms(variants, libs, seed)
    return recs


def _moe_call(fn, x, eids, planes, bound):
    """One call of a variant's MoE entry on one plane set."""
    R = x.shape[0]
    E, q_out, Gp = planes.shape
    out = torch.empty((R, q_out), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), eids.data_ptr(), planes.data_ptr(), None,
             out.data_ptr(), R, bound, E, q_out, Gp, 1, AFFINE[0][0], 0.0,
             AFFINE[0][1], int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moe variant launch failed: cudaError {err}")
    return out


def run_moe(variants: List[str], fns: Dict, gen) -> List[Dict]:
    """Each variant's MoE entry at Mixtral-8x7B's w13 and w2 (8 experts of
    random words, one plane set, bf16 x) for R = 2, 16 and 62 top-2 rows
    (R/2 tokens, the bound R/2), L2-cold planes, in the order given and
    back; beside the bound (the distinct experts' planes, x and out at
    3.35 TB/s) and the library yardstick, one bf16 product per distinct
    expert on its weights decoded beforehand. Then the sums over a step's
    64 calls."""
    dev = torch.device("cuda")
    order = variants + variants[::-1]
    recs = []
    for name, q_out, q_in in MOE_SHAPES:
        G, Gp = q_in // 8, -(-(q_in // 8) // 128) * 128
        planes = torch.randint(-2 ** 31, 2 ** 31 - 1, (MOE_E, q_out, Gp),
                               generator=gen, device=dev,
                               dtype=torch.int64).to(torch.int32)
        cp = [c[0] for c in tm.cold_copies([planes])]
        expert_bytes = q_out * Gp * 4
        for R in MOE_R:
            tokens = R // 2
            eids = torch.stack([torch.randperm(MOE_E, generator=gen,
                                               device=dev)[:2]
                                for _ in range(tokens)]).reshape(-1).to(
                torch.int32)
            distinct = sorted(set(eids.tolist()))
            x = torch.zeros((R, 8, Gp), device=dev)
            x[:, :, :G] = torch.randn((R, 8, G), generator=gen, device=dev)
            x = x.reshape(R, 8 * Gp).to(torch.bfloat16)
            want = mm.moe_fused_matmul_ref(x, eids, [planes], AFFINE)
            times = {v: [] for v in variants}
            for v in order:
                times[v].append(tm.graph_us(
                    lambda i: _moe_call(fns[v], x, eids, cp[i % len(cp)],
                                        tokens), 4 * len(cp)))
            x_nat = x.reshape(R, 8, Gp)[:, :, :G].transpose(1, 2).reshape(
                R, q_in)
            xs = {e: x_nat[eids == e].contiguous() for e in distinct}
            Ws = {e: decode_weights(QuantizedTensor(
                {"w0": planes[e]}, "E8P12", q_out, q_in),
                dtype=torch.bfloat16) for e in distinct}
            lib_us = tm.graph_us(
                lambda i: [torch.matmul(xs[e], Ws[e].T) for e in distinct], 4)
            del Ws
            nbytes = len(distinct) * expert_bytes + R * 8 * Gp * 2 + \
                R * q_out * 2 + R * 4
            for v in variants:
                rec = {"variant": v, "layout": "moe", "layer": name,
                       "q_out": q_out, "Gp": Gp, "R": R,
                       "experts": len(distinct), "us": times[v],
                       "bound_us": nbytes / tm.HBM_BYTES_PER_S * 1e6,
                       "library_us": lib_us,
                       "err_over_tol": err_over_tol(_moe_call(
                           fns[v], x, eids, planes, tokens), want)}
                recs.append(rec)
                print(json.dumps(rec), flush=True)
        del planes, cp
        torch.cuda.empty_cache()
    for v in variants:
        for R in MOE_R:
            sel = [r for r in recs if r["variant"] == v and r["R"] == R]

            def tot(k):
                return sum(MOE_CALLS[r["layer"]] * (
                    sum(r[k]) / len(r[k]) if k == "us" else r[k])
                    for r in sel) * 1e-3
            print(json.dumps({
                "variant": v, "layout": "moe", "R": R,
                "per": {2: "token", 16: "8 tokens",
                        62: "31-token prefill"}[R],
                "calls": sum(MOE_CALLS.values()), "ms": tot("us"),
                "bound_ms": tot("bound_us"), "library_ms": tot("library_us"),
                "worst_err_over_tol": max(r["err_over_tol"] for r in sel)}),
                flush=True)
    return recs


def prefill_ms(variants: List[str], libs: Dict, seed: int = 0,
               S: int = 32, reps: int = 10, layout: str = "nibble") -> Dict:
    """Device ms of Llama-2-7B's S-token bf16 prefill (random codes from
    ``seed``, fused qkv and gate/up, quantized head, as chip_smoke.py's
    paths: E8P12 nibble for ``layout`` nibble, E8P12 bfp, E8P12RVQ4B pb or
    paired, E8P12 u3) with each variant's kernel in place of the built
    one: the prefill
    captured in a CUDA graph and replayed ``reps`` times, every variant in
    the order given and back. The 129 linears must launch the layout's
    kernel (its wrapper's counter counts them)."""
    import quip_for_all_tpu_torch as qt
    stem = ENTRIES[layout][0]
    counter = {"nibble": fm.fused_decode_matmul, "pb": rm.rowpair_pb_matmul,
               "paired": rm.paired_decode_matmul,
               "u3": rm.rowpair_u3_matmul,
               "bfp": lm.bfp_decode_matmul}[layout]
    cfg = qt.llama2_7b_config()
    if layout == "nibble":
        model = qt.random_quantized_model(
            cfg, seed=seed, dtype=torch.bfloat16, quantize_head=True,
            device="cuda")
    else:
        model = qt.random_quantized_model(
            cfg, "E8P12" if layout in ("u3", "bfp") else "E8P12RVQ4B",
            seed=seed, dtype=torch.bfloat16, quantize_head=True,
            device="cuda", layout=layout)
    model = qt.fuse_for_inference(cfg, model)
    return _time_prefill(variants, libs, cfg, model, seed, S, reps, stem,
                         counter, 4 * 32 + 1, layout)


def mixtral_prefill_ms(variants: List[str], libs: Dict, seed: int = 0,
                       S: int = 16, reps: int = 10) -> Dict:
    """Device ms of Mixtral-8x7B's S-token bf16 sparse prefill (S < 32:
    the MoE kernel takes R = 2S top-2 rows a call with the bound S; random
    E8P12 codes from ``seed``, experts stacked, fused qkv, quantized head,
    as chip_smoke.py's phase 6) with each variant's MoE kernel in place of
    the built one, timed as ``prefill_ms``; the 32 layers' 64 MoE calls
    must launch it."""
    import quip_for_all_tpu_torch as qt
    from ..models.config import mixtral_8x7b_config
    cfg = mixtral_8x7b_config()
    model = qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, seed=seed, dtype=torch.bfloat16, quantize_head=True,
        device="cuda"))
    return _time_prefill(variants, libs, cfg, model, seed, S, reps,
                         ENTRIES["moe"][0], mm.moe_fused_matmul,
                         2 * cfg.num_hidden_layers, "moe")


def _time_prefill(variants, libs, cfg, model, seed, S, reps, stem, counter,
                  launches, layout):
    """The S-token prefill of ``model`` captured in a CUDA graph and
    replayed ``reps`` times with each variant's library ``stem`` in place,
    in the order given and back; each variant's run must count
    ``launches`` on ``counter``. Frees the model."""
    from ..models import llama as M
    from ..runtime.generate import attn_bucket, init_kv_caches
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
            _build._libs[stem] = libs[(v, stem)]
            before = counter.launches
            step(0)
            torch.cuda.synchronize()
            if counter.launches - before != launches:
                raise RuntimeError(f"the prefill did not run the {layout} "
                                   f"kernel {launches} times")
            times[v].append(1e-3 * tm.graph_us(step, 1, reps=reps))
    finally:
        _build._libs.pop(stem, None)
        del model, caches
        torch.cuda.empty_cache()
    for v in variants:
        print(json.dumps({"variant": v, "layout": layout,
                          "prefill_tokens": S,
                          "prefill_device_ms": times[v]}), flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="default: every variant of RULES (but simt with "
                         "a layout it has no body for)")
    ap.add_argument("--m", default="1,8,16,32")
    ap.add_argument("--layouts", default="nibble,sw4",
                    help="of nibble, sw2, sw4, ksplit4, bfp, pb, paired, "
                         "u3, moe")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="the csrc directory of the parent variant")
    ap.add_argument("--prefill", action="store_true",
                    help="also time Llama-2-7B's 32-token prefill with "
                         "each variant's kernel (nibble: K1; bfp, pb, "
                         "paired, u3), and with moe Mixtral-8x7B's "
                         "16-token sparse prefill")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    layouts = a.layouts.split(",")
    variants = (a.variants.split(",") if a.variants else
                [v for v in RULES if v != "simt"
                 or all(lay in SIMT_LAYOUTS for lay in layouts)])
    run(variants, [int(v) for v in a.m.split(",")], layouts, a.seed,
        a.prefill, a.parent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
