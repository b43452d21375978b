#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (quip_for_all_tpu_torch) on one CUDA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result
line):
  1. the card (nvidia-smi name and power limit) and the kernels' build from
     the repo's sources (one nvcc per source, all started together);
  2. every ported kernel against its plain torch twin at the Llama-2-7B
     shapes of the main path, m = 1, 8 and 64, with times on the card
     (CUDA-graph replays, L2-cold), the plain twin's time, the bound from
     device-memory bytes at 3.35 TB/s, and a library yardstick;
  3. the golden reference-schema checkpoint through the kernel (f32);
  4. the main path: Llama-2-7B E8P12 (random codes, seed 0), fused qkv and
     gate/up, quantized head, cache_len 2048, bs=1: a 32-token prompt and
     128 greedy tokens through ``generate``, twice, with kernel launch
     counts, and the first 16 tokens held against the same path with every
     linear on the plain twin.
The last stdout line is {"ok": true, "device": {...}}; the line before it
lists the kernels with their numbers.
"""
import json
import math
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core peak, data sheet
REPO = os.path.dirname(os.path.abspath(__file__))
L2_BYTES = 50 * 2 ** 20

KERNELS = [{
    "name": "fused_decode_matmul", "route": "cuda",
    "source": "quip_for_all_tpu_torch/csrc/fused_decode_matmul.cu",
    "replaces": "quip_for_all_tpu/ops/dequant_pallas.py:135",
}]
# Llama-2-7B linears per decode token: (name, q_out, q_in, per layer,
# scale vector in the epilogue on the main path)
SHAPES = [("qkv", 12288, 4096, True), ("o", 4096, 4096, False),
          ("gateup", 22016, 4096, True), ("down", 4096, 11008, False),
          ("head", 32000, 4096, False)]
LAYERS = 32


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bf16_ulp(v):
    import torch
    a = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def graph_ms(fn, n: int, reps: int = 1) -> float:
    """Device ms per call: n calls captured in one CUDA graph, replayed
    reps times between CUDA events (host launch overhead excluded)."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


def event_ms(fn, n: int) -> float:
    import torch
    fn(0)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for i in range(n):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_build():
    from quip_for_all_tpu_torch.ops import _build
    t = time.time()
    reports = _build.build_all([k["name"] for k in KERNELS])
    dt = time.time() - t
    for name in [k["name"] for k in KERNELS]:
        _build.load(name)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(KERNELS)} kernel source(s) in {dt:.1f} s "
        f"({'built' if reports else 'already built'})")
    return dt


def phase_kernels():
    """fused_decode_matmul vs its plain twin at the main path's shapes."""
    import torch
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    from quip_for_all_tpu_torch.ops.dequant import decode_weights
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor
    from quip_for_all_tpu_torch.utils.random_quantized import \
        random_e8p_planes
    gen = torch.Generator(device="cuda").manual_seed(1)
    affine = ((0.5, -2.75),)
    rows, max_err = [], 0.0
    for name, q_out, q_in, with_scale in SHAPES:
        G = q_in // 8
        w = random_e8p_planes(q_out, q_in, gen, "cuda")
        Gp = w.shape[1]
        plane_bytes = w.numel() * 4
        copies = max(2, math.ceil(2 * L2_BYTES / plane_bytes))
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        scale = (torch.rand(q_out, generator=gen, device="cuda") + 0.5
                 if with_scale else None)
        W = decode_weights(QuantizedTensor({"w0": w}, "E8P12", q_out, q_in),
                           dtype=torch.bfloat16)
        w_copies = max(2, math.ceil(2 * L2_BYTES / (W.numel() * 2)))
        Ws = [W] + [W.clone() for _ in range(w_copies - 1)]
        for m in (1, 8, 64):
            # as the main path gives it: x padded to a multiple of 8 rows,
            # the kernel computing the m real ones
            mp = max(8, -(-m // 8) * 8)
            x = torch.zeros((mp, 8, Gp), device="cuda")
            x[:m, :, :G] = torch.randn((m, 8, G), generator=gen,
                                       device="cuda")
            x = x.reshape(mp, 8 * Gp).to(torch.bfloat16)
            got = fm.fused_decode_matmul(x, [w], affine, scale, rows=m)
            want = fm.fused_decode_matmul_ref(x[:m], [w], affine, scale)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            # f32 sum order (1e-5 of the max, as in the f32 tests) plus one
            # bf16 rounding step of the element
            ok = bool(torch.all(diff <= bf16_ulp(torch.maximum(
                got.float().abs(), want.float().abs()))
                + 1e-5 * want.float().abs().max()))
            err = float(diff.max())
            max_err = max(max_err, err)
            if not (ok and torch.isfinite(got.float()).all()):
                raise AssertionError(
                    f"{name} m={m}: kernel vs plain twin beyond tolerance "
                    f"(max |diff| {err})")
            x_nat = x[:m].reshape(m, 8, Gp)[:, :, :G].transpose(
                1, 2).reshape(m, q_in).contiguous()
            k_ms = graph_ms(lambda i: fm.fused_decode_matmul(
                x, [ws[i % copies]], affine, scale, rows=m), 4 * copies)
            p_ms = event_ms(lambda i: fm.fused_decode_matmul_ref(
                x[:m], [ws[i % copies]], affine, scale), 3)
            lib_ms = graph_ms(lambda i: torch.matmul(
                x_nat, Ws[i % w_copies].T), 4 * w_copies)
            nbytes = plane_bytes + m * 8 * Gp * 2 + m * q_out * 2 + (
                q_out * 4 if with_scale else 0)
            ops = 2 * m * q_out * 8 * Gp
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = ops / BF16_OPS_PER_S * 1e3
            row = {"layer": name, "q_out": q_out, "Gp": Gp, "m": m,
                   "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                   "bytes": nbytes}
            rows.append(row)
            log(f"kernel {name:6s} {q_out}x{Gp} m={m:2d}: max|k-plain| "
                f"{err:.3g} (tol 1 bf16 ulp + 1e-5 max) | kernel {k_ms * 1e3:.1f} us "
                f"| plain {p_ms * 1e3:.1f} us | bound {row['bound_ms'] * 1e3:.1f}"
                f" us ({row['bound_by']}) | {k_ms and row['bound_ms'] / k_ms:.0%}"
                f" of bound | library {lib_ms * 1e3:.1f} us (dense bf16 GEMV, "
                f"4x the bytes, not the same function)")
        del ws, Ws, W
        torch.cuda.empty_cache()
    return rows, max_err


def phase_golden():
    """The golden reference-schema fixture, loaded by the port and run on
    the card through the kernel in f32: rel < 2e-4 as the JAX test holds."""
    import numpy as np
    import torch
    from quip_for_all_tpu_torch.utils.checkpoint import load_quantized
    path = os.path.join(REPO, "tests", "golden", "e8p12")
    cfg, model, _ = load_quantized(path, device="cuda")
    exp = np.load(os.path.join(path, "expected.npz"))
    blk = model.layers[0]
    for role, lin in (("q_proj", blk["self_attn"]["q_proj"]),
                      ("down_proj", blk["mlp"]["down_proj"])):
        n = lin.in_features
        got = lin(torch.eye(n, device="cuda"),
                  compute_dtype=torch.float32).cpu().numpy()
        rel = float(np.abs(got - exp[role]).max()
                    / (np.abs(exp[role]).max() + 1e-9))
        log(f"golden e8p12 {role}: rel err {rel:.3g} (tol 2e-4)")
        if not rel < 2e-4:
            raise AssertionError(f"golden {role} rel {rel}")


def phase_main():
    import torch
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    cfg = qt.llama2_7b_config()
    t = time.time()
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.bfloat16,
                                      quantize_head=True, device="cuda")
    model = qt.fuse_for_inference(cfg, model)
    torch.cuda.synchronize()
    log(f"main: built Llama-2-7B E8P12 (random codes, seed 0, fused, "
        f"quantized head) in {time.time() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, NEW, CACHE = 32, 128, 2048
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")

    def run(n, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = qt.generate(cfg, model, prompt, n, cache_len=CACHE,
                          dtype=torch.bfloat16, return_logits=True, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(4)                                           # warm-up
    (_, _), t_pre = run(1)                           # prefill only
    fm.fused_decode_matmul.launches = 0
    (ids1, logits1), t1 = run(NEW)
    launches = fm.fused_decode_matmul.launches
    (ids2, _), t2 = run(NEW)
    per_step = 4 * LAYERS + 1
    expect = per_step * NEW           # prefill + (NEW - 1) decode steps
    ms_tok = (t1 - t_pre) / (NEW - 1) * 1e3
    ms_tok2 = (t2 - t_pre) / (NEW - 1) * 1e3
    log(f"main: prompt {S} + {NEW} greedy tokens, cache_len {CACHE}: "
        f"prefill {t_pre * 1e3:.1f} ms, decode {ms_tok:.2f} ms/token "
        f"({1e3 / ms_tok:.1f} tok/s); second run {ms_tok2:.2f} ms/token")
    log(f"main: fused_decode_matmul launches {launches} (expected "
        f"{per_step} per step x {NEW} steps = {expect})")
    if launches != expect:
        raise AssertionError(f"launch count {launches} != {expect}")
    if not torch.equal(ids1, ids2):
        raise AssertionError("two greedy runs gave different ids")
    lg = torch.stack(logits1)
    if lg.shape != (NEW, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError(f"logits {tuple(lg.shape)} not finite/shaped")
    log(f"main: two runs identical ids; logits finite, shape "
        f"{tuple(lg.shape)}")

    # every linear on the plain twin, same path otherwise: in bf16 (the
    # main path; bf16 rounding of every linear output amplifies through 32
    # random layers, hence 5e-2) and in f32 (sum order only, 1e-3)
    for dt, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        check_plain(cfg, model, prompt, dt, tol, CACHE)
    dev_ms, eager_ms = decode_step_device_ms(cfg, model, prompt, CACHE)
    log(f"main: one decode step (position {S}): device time {dev_ms:.2f} ms "
        f"(CUDA-graph replay), eager {eager_ms:.2f} ms -> device idle "
        f"{1 - dev_ms / eager_ms:.0%} of the eager step")
    return launches


def decode_step_device_ms(cfg, model, prompt, cache_len, n=20):
    """Device time of one bf16 decode step: the step captured once in a
    CUDA graph and replayed n times between CUDA events (no host dispatch),
    beside the same step run eagerly n times. The port's decode loop does
    not use graphs yet; this only measures what the device spends."""
    import torch
    from quip_for_all_tpu_torch.models import llama as M
    from quip_for_all_tpu_torch.runtime.generate import (attn_bucket,
                                                         init_kv_caches)
    S = prompt.shape[1]
    caches = init_kv_caches(cfg, 1, cache_len, torch.bfloat16, "cuda")
    M.model_apply(cfg, model, prompt, kv_caches=caches, cache_position=0,
                  dtype=torch.bfloat16, attn_window=attn_bucket(S, cache_len))
    tok, pos = prompt[:, -1:], torch.full((1, 1), S, device="cuda")
    w = attn_bucket(S + 1, cache_len)

    def step(_):
        return M.model_apply(cfg, model, tok, positions=pos,
                             kv_caches=caches, cache_position=S,
                             dtype=torch.bfloat16, attn_window=w)[0]
    eager = event_ms(step, n)
    return graph_ms(step, 1, reps=n), eager


def check_plain(cfg, model, prompt, dtype, tol, cache_len, n=16):
    """The first decode step's logits and n greedy tokens with every linear
    on the kernel vs on the plain twin. A greedy fork is accepted only at a
    near-tie: the kernel's token within tol*max|logit| of the plain max."""
    import torch
    import quip_for_all_tpu_torch as qt
    S = prompt.shape[1]
    lkw = {"compute_dtype": dtype}
    outs = {}
    for impl in ("auto", "plain"):
        outs[impl] = qt.generate(cfg, model, prompt, n, cache_len=cache_len,
                                 dtype=dtype, return_logits=True,
                                 linear_kw=dict(lkw, matmul_impl=impl))
    (ids_k, lk), (ids_p, lp) = outs["auto"], outs["plain"]
    d1 = float((lk[1] - lp[1]).abs().max() / lp[1].abs().max())
    k_toks, p_toks = ids_k[0, S:], ids_p[0, S:]
    same = int((k_toks == p_toks).long().cumprod(0).sum())
    gap = 0.0
    if same < n:
        row = lp[same][0]
        gap = float((row.max() - row[k_toks[same]]) / row.abs().max())
    label = str(dtype).replace("torch.", "")
    log(f"main [{label}]: first decode step logits, kernel vs plain twin: "
        f"max|diff|/max|logit| {d1:.3g} (tol {tol}); greedy tokens equal "
        f"for {same}/{n} steps" + (
            f"; at step {same} the kernel's token is {gap:.3g} of "
            f"max|logit| below the plain argmax (tol {tol})"
            if same < n else ""))
    if not (d1 <= tol and gap <= tol):
        raise AssertionError(f"{label}: kernel path differs from the plain "
                             "twin beyond tolerance")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "quip_for_all_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "quip_for_all_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = smi_line()
        log(f"card: {smi} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        phase_build()
        log("kernels: " + ", ".join(
            f"{k['name']} ({k['route']}, {k['source']}, replaces "
            f"{k['replaces']})" for k in KERNELS))
        rows, max_err = phase_kernels()
        phase_golden()
        launches = phase_main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    # one decode token's worth of kernel work: one real row per call
    per_tok = [r for r in rows if r["m"] == 1]
    mult = {name: (LAYERS if name != "head" else 1)
            for name, *_ in SHAPES}

    def tok_sum(key):
        return sum(mult[r["layer"]] * r[key] for r in per_tok)
    k = dict(KERNELS[0], launches=launches, max_abs_err=max_err,
             ms=tok_sum("ms"), plain_ms=tok_sum("plain_ms"),
             bound_ms=tok_sum("bound_ms"),
             bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                      for r in per_tok) else "operations"),
             library_ms=tok_sum("library_ms"))
    log(f"card: {smi_line()}")
    log(json.dumps({"kernels": [k]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
