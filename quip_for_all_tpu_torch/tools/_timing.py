"""What the microbenchmarks share: the device, the call of a kernel's C
entry point, the tolerance of a kernel against its twin, and the timing on
the card.

A kernel's time is device milliseconds per call from a CUDA-graph replay
(host launch overhead excluded), its inputs cycled over enough copies that
each call finds them evicted from the 50 MB L2, as a decode step finds a
layer's planes. The bound is the larger of the bytes a call must move
(each input read once, the output written once) over the H100 SXM
data-sheet 3.35 TB/s and its operations over the peak for their type. The
twin's time is eager (CUDA events over a few calls). A variant's library
yardstick is one PyTorch call that computes its own function: for a
decode+matvec, one bf16 ``torch.matmul`` on weights decoded beforehand;
for a load floor, the reduction or product it does. The port never calls
them. ``chip_smoke.py`` times and checks every kernel with these
functions too.
"""
from __future__ import annotations

import ctypes
import json
import math
from typing import Callable, Dict, Optional, Sequence

import torch

from ..utils.device import resolve_device  # noqa: F401  (the tools' entry)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20


def launch(kernel: str, entry: str, argtypes: Sequence, *args) -> None:
    """One call of ``csrc/<kernel>.cu``'s C entry point (built at first
    use); raises on a nonzero cudaError."""
    from ..ops._build import load
    fn = getattr(load(kernel), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int,
                 device: Optional[torch.device] = None) -> None:
    """dtype, rank, contiguity, device and (on a card) 16-byte alignment:
    raises on anything a kernel does not take."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"the kernel needs a 16-byte aligned {name}")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(got: torch.Tensor, want: torch.Tensor,
            bf16_step: Optional[bool] = None):
    """(ok, max |diff|, rel_err, tolerance text). Within 1e-5 of max|want|
    (sums run in another order), plus one bf16 ulp of the element where
    ``bf16_step`` (by default: for bf16 outputs, whose cast may round the
    other way); shape and dtype equal, the kernel's output finite."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    big = float(w.abs().max()) if w.numel() else 0.0
    tol = torch.full_like(diff, 1e-5 * big)
    text = "1e-5 max"
    if bf16_step is None:
        bf16_step = got.dtype == torch.bfloat16
    if bf16_step:
        tol = tol + _bf16_ulp(torch.maximum(g.abs(), w.abs()))
        text = "1 bf16 ulp + 1e-5 max"
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.all(diff <= tol)) and bool(torch.isfinite(g).all()))
    err = float(diff.max()) if diff.numel() else 0.0
    return ok, err, err / (big + 1e-30), text


def graph_us(fn: Callable[[int], object], n: int, reps: int = 1) -> float:
    """Device microseconds per call: n calls captured in one CUDA graph
    and replayed ``reps`` times between CUDA events, after a warm replay
    (host launch overhead excluded)."""
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
    return t0.elapsed_time(t1) * 1e3 / (n * reps)


def event_us(fn: Callable[[int], object], n: int = 3) -> float:
    """Eager microseconds per call between CUDA events (host included)."""
    fn(0)
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for i in range(n):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / n


# The device symbols of the serving path's kernels, by wrapper name
# (``runtime/graphs.py`` ``kernel_wrappers``): every part must appear in
# the symbol. K6 (split-K) shares K1's codes policy; no serving path runs it.
KERNEL_SYMBOLS = (("moe_decode_matmul", ("mma_small_kernel", "MoeCodes<")),
                  ("fused_decode_matmul_tc", ("nibble_mma_fwd_kernel",)),
                  ("fused_decode_matmul", ("mma_small_kernel",
                                           "NibbleCodes<")))


def traced_launches(fn: Callable[[], object], path: str) -> Dict[str, int]:
    """Run ``fn`` under ``torch.profiler`` and count, by wrapper name, the
    kernels of ``KERNEL_SYMBOLS`` that the trace shows ran on the card
    (the chrome trace is written to ``path``). A CUDA-graph replay does
    not call the wrappers, so their host counts reckon it from the
    capture; this count is the device's own."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {k: 0 for k, _ in KERNEL_SYMBOLS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k, parts in KERNEL_SYMBOLS:
            if all(p in e["name"] for p in parts):
                counts[k] += 1
                break
    return counts


def cold_copies(args) -> list:
    """``args`` (a list, tuple or dict of tensors) and clones of it, enough
    that cycling through them finds each set evicted from the L2."""
    vals = list(args.values()) if isinstance(args, dict) else list(args)
    nbytes = sum(t.numel() * t.element_size() for t in vals)
    n = max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))
    if isinstance(args, dict):
        return [args] + [{k: v.clone() for k, v in args.items()}
                         for _ in range(n - 1)]
    return [args] + [type(args)(t.clone() for t in args)
                     for _ in range(n - 1)]


def _calls(iters: int, copies: int) -> int:
    """Calls in the timed graph: at least ``iters`` and 4 passes over the
    copies, a whole number of passes."""
    n = max(iters, 4 * copies)
    return -(-n // copies) * copies


def measure(call: Callable, twin: Callable, args: Sequence[torch.Tensor],
            counter: Callable, *, nbytes: int, ops: int, ops_per_s: float,
            iters: int, **info) -> Dict:
    """One variant: the kernel (``call``) against its twin on ``args``,
    then on a card their times and the bound. ``counter`` is the wrapper
    whose ``.launches`` the call adds to; the record's ``launches`` is what
    this variant added (the check, the warm-up and the captured calls).
    On the CPU the wrapper is the twin and nothing is timed."""
    before = counter.launches
    got = call(*args)
    want = twin(*args)
    dev = args[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ok, err, rel, tol = compare(got, want)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    b_ops = ops / ops_per_s * 1e6
    rec = dict(info, device=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
               ok=ok, max_abs_err=err, rel_err=rel, tol=tol, bytes=nbytes,
               bound_us=max(b_bytes, b_ops),
               bound_by="bytes" if b_bytes >= b_ops else "operations",
               us=None, plain_us=None, gbps=None, pct_of_bound=None)
    if dev.type == "cuda":
        cp = cold_copies(args)
        us = graph_us(lambda i: call(*cp[i % len(cp)]),
                      _calls(iters, len(cp)))
        rec.update(us=us, plain_us=event_us(
            lambda i: twin(*cp[i % len(cp)])),
            gbps=nbytes / us * 1e-3, pct_of_bound=100 * rec["bound_us"] / us)
    rec["launches"] = counter.launches - before
    return rec


def library_us(fn: Callable, args: Sequence[torch.Tensor]
               ) -> Optional[float]:
    """The yardstick ``fn(*args)``, one PyTorch call, timed as a kernel is
    (L2-cold copies of ``args``); None on the CPU."""
    if args[0].device.type != "cuda":
        return None
    cp = cold_copies(tuple(args))
    return graph_us(lambda i: fn(*cp[i % len(cp)]), _calls(64, len(cp)))


def product_us(W: torch.Tensor, m: int) -> Optional[float]:
    """The decode+matvec yardstick: ``x @ W.T`` in bf16 (x random (m, K),
    W (N, K) decoded beforehand); None on the CPU."""
    if W.device.type != "cuda":
        return None
    W = W.to(torch.bfloat16).contiguous()
    x = torch.randn((m, W.shape[1]), device=W.device,
                    generator=torch.Generator(W.device).manual_seed(0)
                    ).to(torch.bfloat16)
    return library_us(lambda w: torch.matmul(x, w.T), (W,))


def emit(records: Sequence[Dict]) -> int:
    """Print one JSON line per record; 1 if any kernel left its tolerance,
    else 0 (``main``'s exit code)."""
    for r in records:
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in records) else 1
