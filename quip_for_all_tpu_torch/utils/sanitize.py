"""Runtime sanitizer: determinism, purity, finiteness and kernel-variant
parity checks of the port's programs — counterpart of
``quip_for_all_tpu/utils/sanitize.py``.

On the card these checks reach classes of bug that the CPU tests cannot:

  * nondeterminism (a reduce whose order depends on scheduling, a
    kernel reading memory it never wrote) -> ``check_determinism`` runs a
    program repeatedly on the same inputs and bit-compares every output;
    each run's outputs are cloned before the next run, so a program that
    writes its results into the same buffers each time (a CUDA graph
    replay into its static outputs) is compared run against run, not a
    buffer against itself;
  * a kernel or a wrapper writing into its inputs -> ``check_purity``
    snapshots every input leaf and bit-compares it after the call;
  * non-finite values -> ``check_finite``;
  * a wrong kernel variant -> ``check_variant_parity`` runs one quantized
    product through the base kernel and each variant of ``VARIANTS`` and
    compares them, and the base run against the dense decode
    (``ops/dequant.py`` ``decode_weights`` and one product);
    ``check_stacked_parity`` holds the MoE kernel on stacked experts to
    the same decode, expert by expert.

Every comparison stays on the device (``torch.equal`` on the bytes), so
checking a model on the card copies nothing to the host. Leaves are the
tensors (and numpy arrays and Python numbers) found in nested lists,
tuples, dicts and dataclasses, and an ``nn.Module``'s parameters and
buffers.

Where the port differs from the JAX copy (the faults ``ADVICE.md``
records there, none kept here):
  * ``sanitize_decode_step`` runs every family, through
    ``models/registry.py`` ``get_arch`` (JAX's imports llama);
  * ``check_determinism`` clones each run's outputs (JAX's keeps
    ``np.asarray`` views of its baseline);
  * ``check_finite`` upcasts only f16 and bf16, tests f64 as it is and a
    complex leaf on its real and imaginary parts (JAX's casts every leaf
    to f32: a finite f64 above f32's range reads as infinite there, and
    an imaginary part is dropped);
  * each variant-parity run records the function it reached (a CUDA
    kernel by its wrapper, or a plain twin); a variant that reached the
    base run's function is recorded as skipped with the reason, never as
    a pass (JAX's passes when every run took one route).
The KV caches are written in place by design (JAX's step returns new
caches): ``check_determinism`` starts every run from a copy of the
declared ``state``, and ``check_purity`` takes that state as the
program's own and does not flag it. A deleted (donated) JAX buffer has
no counterpart here.

Every check returns a ``SanitizerReport``; nothing raises unless
``strict=True``. CLI: ``python -m quip_for_all_tpu_torch.tools.sanitize``.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class Finding:
    check: str
    leaf: str
    detail: str


@dataclasses.dataclass
class SanitizerReport:
    """``findings`` fail the report; ``skipped`` records a check that
    compared nothing, with the reason (it is not a pass); ``runs`` holds
    one record a variant-parity run: the leaf, rows, variant, the function
    it reached and its max |diff|."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    checks_run: List[str] = dataclasses.field(default_factory=list)
    skipped: List[Finding] = dataclasses.field(default_factory=list)
    runs: List[dict] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def add(self, check: str, leaf: str, detail: str) -> None:
        self.findings.append(Finding(check, leaf, detail))

    def skip(self, check: str, leaf: str, reason: str) -> None:
        self.skipped.append(Finding(check, leaf, reason))

    def merge(self, other: "SanitizerReport") -> "SanitizerReport":
        self.findings.extend(other.findings)
        self.checks_run.extend(other.checks_run)
        self.skipped.extend(other.skipped)
        self.runs.extend(other.runs)
        return self

    def summary(self) -> str:
        checks = ", ".join(dict.fromkeys(self.checks_run))
        if self.ok:
            lines = [f"sanitizer OK ({checks})"]
        else:
            lines = [f"sanitizer: {len(self.findings)} finding(s):"]
            for f in self.findings:
                lines.append(f"  [{f.check}] {f.leaf}: {f.detail}")
        for f in self.skipped:
            lines.append(f"  [{f.check} skipped] {f.leaf}: {f.detail}")
        return "\n".join(lines)

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise AssertionError(self.summary())


# --------------------------------------------------------------- leaves

def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every tensor, numpy array and Python number in
    ``tree``; other objects are not leaves and are passed by."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(path, tree)]
    if isinstance(tree, (bool, int, float, complex)):
        return [(path, tree)]
    if isinstance(tree, nn.Module):
        out = []
        for name, t in tree.named_parameters():
            out.append((f"{path}.{name}", t))
        for name, t in tree.named_buffers():
            out.append((f"{path}.{name}", t))
        return out
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{path}[{i}]")
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _leaves(getattr(tree, f.name), f"{path}.{f.name}")
        return out
    return []


def _snapshot(leaf: Any) -> Any:
    """A copy that no later write to ``leaf`` reaches (on its device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous().reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.view(torch.uint8)


def _bits_equal(a: Any, b: Any) -> bool:
    """Bit for bit: the same NaN payloads count as equal, -0.0 and 0.0 as
    different (a deterministic program reproduces its bits)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if (a.shape != b.shape or a.dtype != b.dtype
                or a.device != b.device):
            return False
        return torch.equal(_bytes(a), _bytes(b))
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return (a.shape == b.shape and a.dtype == b.dtype
                and np.ascontiguousarray(a).tobytes()
                == np.ascontiguousarray(b).tobytes())
    if type(a) is not type(b):
        return False
    return a == b or (a != a and b != b)


def _n_differ(a: Any, b: Any) -> str:
    if isinstance(a, torch.Tensor) and a.shape == getattr(b, "shape", None) \
            and a.dtype == b.dtype:
        return f" ({int((a != b).sum())}/{a.numel()} elements differ)"
    if isinstance(a, np.ndarray) and a.shape == getattr(b, "shape", None) \
            and a.dtype == b.dtype:
        return f" ({int(np.sum(a != b))}/{a.size} elements differ)"
    return ""


def _storages(tree: Any) -> set:
    return {t.untyped_storage().data_ptr() for _, t in _leaves(tree)
            if isinstance(t, torch.Tensor)}


# --------------------------------------------------------------- checks

def check_determinism(fn: Callable, args: Sequence[Any], *,
                      repeats: int = 3, state: Any = None,
                      name: str = "out",
                      strict: bool = False) -> SanitizerReport:
    """Run ``fn(*args)`` ``repeats`` times and bit-compare every output
    leaf with the first run's. Each run's outputs are cloned before the
    next, so buffers a program reuses are compared run against run.
    ``state`` lists the tensors ``fn`` writes by design (the KV caches):
    each run starts from a copy of their values before the first, and
    they get those values back at the end."""
    rep = SanitizerReport(checks_run=["determinism"])
    saved = [(t, t.detach().clone()) for _, t in _leaves(state)
             if isinstance(t, torch.Tensor)]
    baseline = None
    try:
        for i in range(repeats):
            with torch.no_grad():
                for t, v in saved:
                    t.copy_(v)
            flat = [(p, _snapshot(v)) for p, v in _leaves(fn(*args), name)]
            if baseline is None:
                baseline = flat
                continue
            if len(flat) != len(baseline):
                rep.add("determinism", "<structure>",
                        f"run {i} returned {len(flat)} leaves vs "
                        f"{len(baseline)} in run 0")
                break
            for (path, ref), (_, got) in zip(baseline, flat):
                if not _bits_equal(ref, got):
                    rep.add("determinism", path, f"run {i} differs from "
                            f"run 0{_n_differ(ref, got)}")
    finally:
        with torch.no_grad():
            for t, v in saved:
                t.copy_(v)
    if strict:
        rep.raise_if_failed()
    return rep


def check_purity(fn: Callable, args: Sequence[Any], *, state: Any = None,
                 strict: bool = False) -> SanitizerReport:
    """Snapshot every input leaf (on its device), call ``fn(*args)`` and
    bit-compare each leaf with its snapshot: a kernel, a wrapper or a C
    entry writing into its inputs. Leaves that share storage with
    ``state`` (the KV caches a step writes by design) are the program's
    own and are not flagged."""
    rep = SanitizerReport(checks_run=["purity"])
    own = _storages(state)
    before = [(p, leaf, _snapshot(leaf)) for p, leaf in _leaves(args, "args")
              if not (isinstance(leaf, torch.Tensor)
                      and leaf.untyped_storage().data_ptr() in own)]
    with torch.no_grad():
        fn(*args)
    for path, leaf, ref in before:
        if isinstance(leaf, (torch.Tensor, np.ndarray)) and not _bits_equal(
                ref, leaf):
            rep.add("purity", path, "input buffer mutated in place")
    if strict:
        rep.raise_if_failed()
    return rep


def _non_finite(leaf: Any) -> Optional[Tuple[int, int]]:
    """(non-finite elements, elements) of a float or complex leaf, None
    for any other. f16 and bf16 are tested in f32, everything else in its
    own type; a complex element is non-finite where its real or its
    imaginary part is."""
    if isinstance(leaf, (float, complex)):
        leaf = np.asarray(leaf)
    if isinstance(leaf, np.ndarray):
        if leaf.dtype.kind == "c":
            bad = ~(np.isfinite(leaf.real) & np.isfinite(leaf.imag))
        elif leaf.dtype.kind == "f":
            bad = ~np.isfinite(leaf)
        else:
            return None
        return int(bad.sum()), leaf.size
    if not isinstance(leaf, torch.Tensor):
        return None
    t = leaf.detach()
    if t.is_complex():
        bad = ~torch.isfinite(torch.view_as_real(t)).all(dim=-1)
    elif t.is_floating_point():
        if t.dtype in (torch.float16, torch.bfloat16):
            t = t.to(torch.float32)
        bad = ~torch.isfinite(t)
    else:
        return None
    return int(bad.sum()), t.numel()


def check_finite(tree: Any, *, name: str = "tree",
                 strict: bool = False) -> SanitizerReport:
    """Walk ``tree`` for NaN/Inf in floating and complex leaves."""
    rep = SanitizerReport(checks_run=["finite"])
    for path, leaf in _leaves(tree, name):
        res = _non_finite(leaf)
        if res is not None and res[0]:
            rep.add("finite", path, f"{res[0]}/{res[1]} non-finite values")
    if strict:
        rep.raise_if_failed()
    return rep


# ------------------------------------------------------- variant parity

# The port's counterpart of the JAX package's VARIANT_KNOBS: (name, the
# keyword arguments of ``fused_quant_matmul``, bit_exact).
#  * QFA_F32_SMALL_M, QFA_MAGIC_SMALL_M and the two together: formulations
#    inside the TPU body's small-m decode (an f32 product, a magic-number
#    int-to-float convert). Each CUDA body has one formulation, so the
#    port has no counterpart of these three.
#  * QFA_KSPLIT=2: the port's ``ksplit`` (the split-K kernel K6 against
#    K1), whose chunk partials are added in chunk order: the tolerance
#    compare, as in JAX.
VARIANTS: List[tuple] = [("ksplit=2", {"ksplit": 2}, False)]

# kernel ids (ROADMAP.md queue 2) by wrapper
KERNEL_IDS = {"fused_decode_matmul": "K1", "fused_decode_matmul_tc": "K2",
              "fused_decode_matmul_bwd": "K3", "moe_decode_matmul": "K4",
              "ksplit_decode_matmul": "K6", "paired_decode_matmul": "K7",
              "rowpair_pb_decode_matmul": "K8",
              "rowpair_u3_decode_matmul": "K9", "bfp_decode_matmul": "K10",
              "sw_decode_matmul": "K11"}


def _twin_codes() -> Dict[Any, str]:
    from ..ops import fused_matmul as fm
    from ..ops import layout_matmul as lm
    from ..ops import moe_matmul as mm
    from ..ops import rowpair_matmul as rm
    from ..ops.dequant import decode_weights
    fns = (fm.fused_decode_matmul_ref, lm.ksplit_decode_matmul_ref,
           lm.sw_decode_matmul_ref,
           lm.bfp_decode_matmul_ref, rm.rowpair_matmul_ref,
           mm.moe_fused_matmul_ref, decode_weights)
    return {f.__code__: f.__name__ for f in fns}


def reached(call: Callable[[], Any]) -> Tuple[Any, str]:
    """(``call()``, the function it reached): the CUDA kernels whose
    wrappers' launch counts moved, by id and wrapper name; else the first
    plain twin (or ``decode_weights``) it called; else "none"."""
    from ..runtime.graphs import kernel_wrappers
    wrappers = kernel_wrappers()
    before = {k: f.launches for k, f in wrappers.items()}
    codes = _twin_codes()
    twins: List[str] = []

    def prof(frame, event, arg):
        if event == "call" and not twins and frame.f_code in codes:
            twins.append(codes[frame.f_code])
    prev = sys.getprofile()
    sys.setprofile(prof)
    try:
        out = call()
    finally:
        sys.setprofile(prev)
    moved = [k for k, f in wrappers.items() if f.launches != before[k]]
    if moved:
        return out, " + ".join(f"{KERNEL_IDS.get(k, '?')} {k} (CUDA)"
                               for k in moved)
    if twins:
        what = "dense decode" if twins[0] == "decode_weights" else "plain twin"
        return out, f"{twins[0]} ({what})"
    return out, "none"


def _tol(scale: float) -> float:
    return 0.05 * scale + 1e-3


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def _dense_product(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """x @ W^T with f32 sums, cast to x's dtype (the JAX check's
    ``dot_general`` with ``preferred_element_type=f32``)."""
    return (x.to(torch.float32) @ W.to(torch.float32).T).to(x.dtype)


def check_variant_parity(qt, x: torch.Tensor, *,
                         variants: Optional[List[tuple]] = None,
                         leaf: str = "",
                         strict: bool = False) -> SanitizerReport:
    """``x @ qt^T`` (x (m, q_in) in natural order) through the fused
    route (``ops/fused_matmul.py`` ``fused_quant_matmul``: on a card K1 at
    m <= 32, or the layout's kernel) and through each of ``variants``
    (default ``VARIANTS``), each run recording the function it reached; a
    bit-exact variant is bit-compared with the base run, the others held
    to it at the JAX tolerance (0.05 scale + 1e-3, scale = max|dense|); a
    variant that reached the base run's function is skipped. The base
    run is held at that tolerance to the independent dense decode
    (``decode_weights`` and one product with f32 sums)."""
    from ..ops.dequant import decode_weights
    from ..ops.fused_matmul import fused_quant_matmul
    rep = SanitizerReport(checks_run=["variant_parity"])
    m = x.shape[0]
    with torch.no_grad():
        base, base_fn = reached(lambda: fused_quant_matmul(x, qt))
        dense, dense_fn = reached(lambda: _dense_product(
            x, decode_weights(qt, dtype=x.dtype)))
    scale = float(dense.to(torch.float32).abs().max()) or 1.0
    err = _max_diff(base, dense)
    ok = err <= _tol(scale)
    rep.runs.append({"leaf": leaf, "m": m, "variant": "base",
                     "reached": base_fn, "against": dense_fn,
                     "max_abs_diff": err, "scale": scale,
                     "status": "pass" if ok else "fail"})
    if not ok:
        rep.add("variant_parity", f"{leaf} m={m} base-vs-dense",
                f"max |diff| {err:.3e} (scale {scale:.3e}) between the "
                f"fused route ({base_fn}) and the dense decode")
    for tag, kw, bit_exact in (VARIANTS if variants is None else variants):
        with torch.no_grad():
            got, fn = reached(lambda: fused_quant_matmul(x, qt, **kw))
        diff = _max_diff(got, base)
        run = {"leaf": leaf, "m": m, "variant": tag, "reached": fn,
               "against": base_fn, "max_abs_diff": diff, "scale": scale}
        where = f"{leaf} m={m} {tag}"
        if fn == base_fn:
            run["status"] = "skipped"
            rep.skip("variant_parity", where,
                     f"reached {fn}, the base run's function: nothing to "
                     "compare")
        elif bit_exact and not _bits_equal(got, base):
            run["status"] = "fail"
            rep.add("variant_parity", where,
                    f"max |diff| {diff:.3e} vs the base run ({fn} against "
                    f"{base_fn}, bit-exact by design)")
        elif not bit_exact and diff > _tol(scale):
            run["status"] = "fail"
            rep.add("variant_parity", where,
                    f"max |diff| {diff:.3e} (scale {scale:.3e}) vs the base "
                    f"run ({fn} against {base_fn})")
        else:
            run["status"] = "pass"
        rep.runs.append(run)
    if strict:
        rep.raise_if_failed()
    return rep


def check_stacked_parity(sq, x: torch.Tensor, eids: torch.Tensor, *,
                         leaf: str = "",
                         strict: bool = False) -> SanitizerReport:
    """A stacked expert linear (``nn/qmoe.py`` ``StackedQuantLinear``):
    rows x (R, q_in) in natural order, each row through its expert ``eids``
    (int32), via the MoE kernel (``ops/moe_matmul.py`` ``moe_fused_matmul``,
    K4 on a card) against each expert's dense decode and one product, at
    the JAX tolerance. The K4 body has one formulation and no split, so
    it has no variant."""
    from ..ops.dequant import decode_weights
    from ..ops.fused_matmul import grouped_permute
    from ..ops.moe_matmul import moe_fused_matmul
    from ..ops.qtensor import QuantizedTensor, decode_affine
    rep = SanitizerReport(checks_run=["variant_parity"])
    planes = sq.plane_list()
    affine = decode_affine(sq.codebook_id, sq.opt_resid_scale)
    R = x.shape[0]
    with torch.no_grad():
        x_perm = grouped_permute(x, planes[0].shape[-1]).contiguous()
        base, base_fn = reached(lambda: moe_fused_matmul(
            x_perm, eids, planes, affine, R))

        def dense_all():
            out = torch.empty_like(base)
            for e in torch.unique(eids).tolist():
                rows = (eids == e).nonzero(as_tuple=True)[0]
                qt = QuantizedTensor({k: v[e] for k, v in sq.planes.items()},
                                     sq.codebook_id, sq.q_out_total, sq.q_in,
                                     sq.opt_resid_scale)
                out[rows] = _dense_product(x[rows],
                                           decode_weights(qt, x.dtype))
            return out
        dense, dense_fn = reached(dense_all)
    scale = float(dense.to(torch.float32).abs().max()) or 1.0
    err = _max_diff(base, dense)
    ok = err <= _tol(scale)
    rep.runs.append({"leaf": leaf, "m": R, "variant": "base",
                     "reached": base_fn, "against": dense_fn,
                     "max_abs_diff": err, "scale": scale,
                     "status": "pass" if ok else "fail"})
    if not ok:
        rep.add("variant_parity", f"{leaf} R={R} base-vs-dense",
                f"max |diff| {err:.3e} (scale {scale:.3e}) between the MoE "
                f"route ({base_fn}) and each expert's dense decode")
    if strict:
        rep.raise_if_failed()
    return rep


# ----------------------------------------------------------- decode step

def sanitize_decode_step(cfg, model, *, cache_len: int = 32,
                         repeats: int = 3, dtype=torch.float32,
                         strict: bool = False) -> SanitizerReport:
    """One-call sanitizer over a model's single-token decode step in
    ``dtype``, for any family (``get_arch``): determinism of the eager
    step and of the step as the decode loop runs it (a
    ``runtime/graphs.py`` ``StepRunner`` body writing its logits into a
    static buffer: one CUDA graph on a card, eager on the CPU), each run
    from the same KV caches in ``dtype``, as the decode loop makes them
    (JAX's step returns new f32 caches; the port's writes them in place);
    purity of the model, the ids and the positions; finite logits."""
    from ..models.registry import get_arch, model_device, rank_config
    from ..runtime.generate import init_kv_caches
    from ..runtime.graphs import StepRunner, graphs_for
    dev = model_device(model)
    model_apply = get_arch(cfg).model_apply
    caches = init_kv_caches(rank_config(cfg, model), 1, cache_len,
                            dtype=dtype, device=dev)
    ids = torch.tensor([[1]], device=dev)
    pos = torch.tensor([[0]], device=dev)

    def step(model, caches, ids, pos):
        with torch.no_grad():
            return model_apply(cfg, model, ids, positions=pos,
                               kv_caches=caches, cache_position=0,
                               dtype=dtype)

    args = (model, caches, ids, pos)
    rep = check_determinism(step, args, repeats=repeats, state=caches,
                            name="step")
    out = torch.zeros((1, cfg.vocab_size), dtype=torch.float32, device=dev)
    runner = StepRunner(dev, [], graphs=graphs_for(model))

    def body():
        out.copy_(step(*args)[0][:, -1].to(torch.float32))

    def stepped():
        runner.run("step", body, 1)
        return out
    rep.merge(check_determinism(stepped, (), repeats=repeats, state=caches,
                                name="runner step"))
    rep.merge(check_purity(step, args, state=caches))
    logits, _ = step(*args)
    rep.merge(check_finite(logits, name="logits"))
    if strict:
        rep.raise_if_failed()
    return rep
