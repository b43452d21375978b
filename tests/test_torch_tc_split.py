"""The tensor-core kernels' arithmetic on the CPU, before the card runs it.

K2 (csrc/fused_decode_matmul_tc.cu) and K3 (csrc/fused_decode_matmul_bwd.cu)
multiply bf16 operands on the tensor cores. An operand that is not a bf16
value (f32 x or g, or bf16 g times an f32 scale vector) is split on
staging into three bf16 terms, hi + mid + lo, each multiplied against the
same decoded nibbles, and each slab of 128 reduction values starts a fresh
f32 accumulator that is then added into an f32 sum. This file emulates
that in torch (the split, the slab order, alpha, beta and the scale as the
kernels apply them) at Llama-2-7B widths (4096 and 11008 along the
reduction) and holds it to the plain twins (``ops/fused_matmul.py``) with
the kernels' tolerance: 1e-5 of the max, plus one bf16 ulp for bf16
outputs. The twins are held to the JAX package in
tests/test_torch_fused_matmul.py and tests/test_torch_k3.py.
"""
import numpy as np
import pytest
import torch

from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops.dequant import nibble_planes

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models, so that a parallel test run
    does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RS = 1 / 3.45
AFFINE = {1: ((0.5, -2.75),), 2: ((0.5, -2.75), (0.5 * RS, -2.75 * RS))}
SLAB = 128                      # reduction values a slab (both kernels)


def split3(v: torch.Tensor):
    """f32 -> three bf16 terms, as the kernels' staging pass: hi = bf16(v),
    mid = bf16(v - hi), lo = bf16(v - hi - mid), each rounded to nearest."""
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def close(got: torch.Tensor, want: torch.Tensor, dtype) -> bool:
    got, want = got.float(), want.float()
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        a = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bool(torch.all((got - want).abs() <= tol))


def planes(q_out, Gp, n_sets, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 1 << 32, (q_out, Gp),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
            for _ in range(n_sets)]


def nib_matrix(w: torch.Tensor) -> torch.Tensor:
    """(q_out, Gp) words -> (q_out, 8*Gp) nibbles in x_perm's lane order."""
    return torch.stack(nibble_planes(w), dim=1).reshape(w.shape[0], -1)


def slab_products(terms, B: torch.Tensor, slabs) -> torch.Tensor:
    """sum over slabs (in order) of the slab's product, each slab a fresh
    f32 accumulator over every term: terms (m, K) bf16, B (K, n) f32."""
    total = None
    for idx in slabs:
        acc = None
        for t in terms:
            p = t.float()[:, idx] @ B[idx]
            acc = p if acc is None else acc + p
        total = acc if total is None else total + acc
    return total


def k2_emulated(x_perm, ws, affine, scale, terms=3):
    """K2's arithmetic: slab s covers groups 16s..16s+15, i.e. the lanes
    i*Gp + 16s + cc of every nibble i."""
    Gp = ws[0].shape[1]
    xf = x_perm.float()
    parts = split3(xf) if terms == 3 else (x_perm.to(torch.bfloat16),)
    slabs = [torch.cat([torch.arange(i * Gp + c0, i * Gp + min(c0 + 16, Gp))
                        for i in range(8)]) for c0 in range(0, Gp, 16)]
    out = None
    for (alpha, _), w in zip(affine, ws):
        t = slab_products(parts, nib_matrix(w).T.contiguous(), slabs) * alpha
        out = t if out is None else out + t
    out = out + float(sum(b for _, b in affine)) * xf.sum(dim=1,
                                                          keepdim=True)
    if scale is not None:
        out = out * scale
    return out.to(x_perm.dtype)


def k3_emulated(g, ws, affine, scale, G, terms=3):
    """K3's arithmetic: gs = g*scale in f32, split, slabs of 128 along q_out,
    dx = sum_s alpha_s*(gs @ nib_s) + beta*rowsum(gs), pad lanes zero."""
    q_out = g.shape[1]
    gs = g.float() if scale is None else g.float() * scale
    parts = split3(gs) if terms == 3 else (gs.to(torch.bfloat16),)
    slabs = [torch.arange(o0, min(o0 + SLAB, q_out))
             for o0 in range(0, q_out, SLAB)]
    out = None
    for (alpha, _), w in zip(affine, ws):
        nat = torch.stack(nibble_planes(w[:, :G]), dim=-1).reshape(q_out, -1)
        t = slab_products(parts, nat, slabs) * alpha
        out = t if out is None else out + t
    out = out + float(sum(b for _, b in affine)) * gs.sum(dim=1,
                                                          keepdim=True)
    return fm.grouped_permute(out, ws[0].shape[1]).to(g.dtype)


@pytest.mark.parametrize("scale_range", [None, (0.5, 1.5), (1e-3, 1e3)])
def test_three_bf16_terms_are_exact(scale_range):
    """hi + mid + lo == v exactly (summed in f64) for f32 values and for
    bf16 g times an f32 scale, over a wide range of magnitudes."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy((rng.standard_normal(1 << 16)
                          * np.exp2(rng.integers(-40, 40, 1 << 16)))
                         .astype(np.float32))
    if scale_range is not None:
        s = torch.from_numpy(rng.uniform(*scale_range, 1 << 16)
                             .astype(np.float32))
        v = v.to(torch.bfloat16).float() * s
    hi, mid, lo = split3(v)
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())


@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("q_in", [4096, 11008])
def test_k2_split_meets_the_tolerance(q_in, n_sets):
    """f32 x (the d scale_vec forward and phase 14's f32 step) at Llama-2-7B
    widths: K2's three-term arithmetic against the f32 twin."""
    G = q_in // 8
    Gp = -(-G // 128) * 128
    q_out, m = 96, 40
    ws = planes(q_out, Gp, n_sets, seed=q_in + n_sets)
    rng = np.random.default_rng(q_in)
    x = np.zeros((m, 8, Gp), np.float32)
    x[:, :, :G] = rng.standard_normal((m, 8, G))
    x = torch.from_numpy(x.reshape(m, 8 * Gp))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, q_out).astype(np.float32))
    want = fm.fused_decode_matmul_ref(x, ws, AFFINE[n_sets], scale)
    assert close(k2_emulated(x, ws, AFFINE[n_sets], scale), want,
                 torch.float32)


@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_out", [4096, 11008])
def test_k3_split_meets_the_tolerance(q_out, dtype, n_sets):
    """gs = g*scale with g f32 or bf16 (the split path) at Llama-2-7B's
    reductions over q_out: K3's three-term arithmetic against the twin."""
    G, Gp, m = 40, 128, 8
    ws = planes(q_out, Gp, n_sets, seed=q_out + n_sets)
    rng = np.random.default_rng(q_out + 1)
    g = torch.from_numpy(rng.standard_normal((m, q_out)).astype(np.float32))
    g = g.to(dtype)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, q_out).astype(np.float32))
    want = fm.fused_decode_matmul_bwd_ref(g, ws, AFFINE[n_sets], scale, G, Gp)
    got = k3_emulated(g, ws, AFFINE[n_sets], scale, G)
    assert torch.all(got.reshape(m, 8, Gp)[:, :, G:] == 0)
    assert close(got, want, dtype)


@pytest.mark.parametrize("case", ["k2_f32_x", "k3_bf16_g_times_scale"])
def test_one_bf16_term_would_miss_the_tolerance(case):
    """The split is needed: the same arithmetic with the operand merely
    rounded to bf16 (one term) leaves the tolerance by far."""
    rng = np.random.default_rng(3)
    if case == "k2_f32_x":
        ws = planes(96, 512, 1, seed=1)
        x = torch.from_numpy(rng.standard_normal((40, 4096))
                             .astype(np.float32))
        want = fm.fused_decode_matmul_ref(x, ws, AFFINE[1])
        one = k2_emulated(x, ws, AFFINE[1], None, terms=1)
        three = k2_emulated(x, ws, AFFINE[1], None)
        dtype = torch.float32
    else:
        ws = planes(4096, 128, 1, seed=2)
        g = torch.from_numpy(rng.standard_normal((8, 4096))
                             .astype(np.float32)).to(torch.bfloat16)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, 4096)
                                 .astype(np.float32))
        want = fm.fused_decode_matmul_bwd_ref(g, ws, AFFINE[1], scale, 40,
                                              128)
        one = k3_emulated(g, ws, AFFINE[1], scale, 40, terms=1)
        three = k3_emulated(g, ws, AFFINE[1], scale, 40)
        dtype = torch.bfloat16
    assert close(three, want, dtype)
    assert not close(one, want, dtype)
