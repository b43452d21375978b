"""The right transform's B-side factor in the kernel epilogue (right_hb)
against the JAX package: every layout's plain twin with right_hb plus
``finish_right`` against the Pallas kernel in interpret mode with the same
right_hb plus the JAX ``finish_right``; QuantLinear, FusedQuantLinear and a
tiny Llama forward with ``set_right_in_kernel`` on against the JAX package
with ``_RIGHT_IN_KERNEL`` patched on (the module reads QFA_RIGHT_IN_KERNEL
once at import, so the attribute is the switch); gradients through K3's
twin against ``jax.grad`` through the custom VJP; shapes that
``right_b_factor`` refuses.

Tolerances:
  - a kernel's output with right_hb: 1e-5 of the max plus one bf16 ulp of
    the element (bf16), plus |Hb| times the two packages' difference
    without right_hb (their first rounding to bf16 may land on
    neighbouring values, which the B x B product carries);
  - ``finish_right`` on one input: 1e-5 of the max (f32) or 1e-2 of the
    max (bf16: each of its products rounds to bf16);
  - whole layers and the model: the repo's layer tolerances, 1e-5 of the
    max in f32 and 1e-2 of the max in bf16 (tests/test_torch_qlinear.py);
  - gradients: rtol = atol = 1e-4, as tests/test_pallas_fused.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import qlinear as JQL
from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops import qtensor as jqt
from quip_for_all_tpu.transforms import incoherence as jinc
from quip_for_all_tpu.utils.random_quantized import (random_qlinear,
                                                     random_quantized_model)

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import qlinear as TQL
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops import qtensor as tqt
from quip_for_all_tpu_torch.transforms import incoherence as tinc
from quip_for_all_tpu_torch.utils.convert import (from_jax_params,
                                                  qlinear_from_jax)

pytestmark = pytest.mark.fast

# (codebook, layout, ksplit, q_in): every kernel that takes right_hb;
# split-K needs 256 (2 chunks) and 512 (4 chunks) groups
LAYOUTS = [("E8P12RVQ4B", "nibble", 0, 1024), ("E8P12", "sw2", 0, 1024),
           ("E8P12RVQ4B", "sw4", 0, 1024), ("E8P12", "bfp", 0, 1024),
           ("E8P12", "nibble", 2, 2048), ("E8P12RVQ4B", "nibble", 4, 4096),
           ("E8P12", "u3", 0, 2048), ("E8P12RVQ4B", "pb", 0, 1024),
           ("E8P12RVQ4B", "paired", 0, 2048)]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(v):
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got, want, dtype, extra=0.0):
    tol = 1e-5 * np.abs(want).max() + extra
    if dtype == "bfloat16":
        tol = tol + bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def carried(d, hb):
    """|Hb| times a per-element difference d (m, q_out) per B-block."""
    m, q_out = d.shape
    B = hb.shape[0]
    return (d.reshape(m, q_out // B, B) @ np.abs(hb).T).reshape(m, q_out)


def _close_rel(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max()


def _tensors(cb, layout, q_out, q_in, seed):
    rng = np.random.default_rng(seed)
    if cb == "E8P12":
        raw = rng.integers(0, 1 << 16, (q_out, q_in // 8)).astype(np.int32)
    else:
        raw = (rng.integers(0, 1 << 62, (q_out, q_in // 8), dtype=np.uint64)
               .astype(np.uint32).view(np.int32))
    j = jqt.from_raw_idxs(jget_codebook(cb), raw, q_out, q_in, layout=layout)
    t = tqt.from_raw_idxs(get_codebook(cb), raw, q_out, q_in, device="cpu",
                          layout=layout)
    return j, t


def _x(m, t, seed):
    x = np.random.default_rng(seed).standard_normal((m, t.q_in)).astype(
        np.float32)
    return tfm.grouped_permute(torch.from_numpy(x), t.group_cols,
                               t.split).numpy()


def _pair(j, t, x, dtype, scale, hb, ksplit, monkeypatch):
    """(JAX kernel, port twin) outputs as f32 numpy."""
    monkeypatch.setenv("QFA_KSPLIT", str(ksplit))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo = jdp.fused_quant_matmul_pre(
        jnp.asarray(x).astype(jdt), j, scale_vec=jnp.asarray(scale),
        right_hb=None if hb is None else jnp.asarray(hb, jnp.float32))
    to = tfm.fused_quant_matmul_pre(
        torch.from_numpy(x).to(tdt), t, scale_vec=torch.from_numpy(scale),
        ksplit=ksplit,
        right_hb=None if hb is None else torch.from_numpy(
            np.asarray(hb, np.float32)))
    assert to.dtype == tdt
    return np.asarray(jo.astype(jnp.float32)), to.float().numpy()


@pytest.mark.parametrize("m,dtype", [(1, "bfloat16"), (40, "bfloat16"),
                                     (8, "float32")])
@pytest.mark.parametrize("cb,layout,ksplit,q_in", LAYOUTS)
def test_twin_with_right_hb_matches_pallas(cb, layout, ksplit, q_in, m,
                                           dtype, monkeypatch):
    """Every layout at q_out 256 (M 256: B 128, H_A 2), both Pallas grids
    (m 1 and 40), then finish_right on each side."""
    q_out = 256
    j, t = _tensors(cb, layout, q_out, q_in, seed=m + q_in)
    x = _x(m, t, seed=m)
    scale = np.random.default_rng(m).uniform(0.5, 1.5, q_out).astype(
        np.float32)
    spec = jinc.HadSpec(None, 1, q_out)
    hb, B = jinc.right_b_factor(spec)
    thb, tB = tinc.right_b_factor(tinc.HadSpec(None, 1, q_out))
    assert tB == B == 128 and np.array_equal(thb, hb)
    j0, t0 = _pair(j, t, x, dtype, scale, None, ksplit, monkeypatch)
    jr, tr = _pair(j, t, x, dtype, scale, hb, ksplit, monkeypatch)
    assert_close(tr, jr, dtype, carried(np.abs(t0 - j0), hb))
    # finish_right (H_A = H_2) on the same input in both packages
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jf = np.asarray(jinc.finish_right(jnp.asarray(jr).astype(jdt), spec)
                    .astype(jnp.float32))
    tf = tinc.finish_right(torch.from_numpy(np.array(jr)).to(tdt),
                           tinc.HadSpec(None, 1, q_out)).float().numpy()
    _close_rel(tf, jf, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_right_hb_with_a_table_hadk(dtype, monkeypatch):
    """q_out 384 with the table factor (use_rand=False): K = 12, M = 32, so
    B = 32 and finish_right applies the 12 x 12 hadK."""
    q_out = 384
    jspec = jinc.get_hadK(q_out, use_rand=False)
    tspec = tinc.get_hadK(q_out, use_rand=False)
    assert jspec.K == tspec.K == 12
    hb, B = jinc.right_b_factor(jspec)
    assert B == 32 and tinc.right_b_factor(tspec)[1] == 32
    j, t = _tensors("E8P12", "nibble", q_out, 1024, seed=3)
    x = _x(3, t, seed=3)
    scale = np.ones(q_out, np.float32)
    j0, t0 = _pair(j, t, x, dtype, scale, None, 0, monkeypatch)
    jr, tr = _pair(j, t, x, dtype, scale, hb, 0, monkeypatch)
    assert_close(tr, jr, dtype, carried(np.abs(t0 - j0), hb))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jf = np.asarray(jinc.finish_right(jnp.asarray(jr).astype(jdt), jspec)
                    .astype(jnp.float32))
    tf = tinc.finish_right(torch.from_numpy(np.array(jr)).to(tdt),
                           tspec).float()
    _close_rel(tf.numpy(), jf, TOL[dtype])


def test_right_b_factor_refusals_match():
    """M < 8, M not a power of 2: both packages refuse the same specs; B is
    2^min(e, 7) on the Llama-2-7B shapes."""
    for n, K in ((4, 1), (12, 3), (48, 4), (40, 2)):
        had = np.eye(K, dtype=np.float32)
        assert jinc.right_b_factor(jinc.HadSpec(had, K, n)) is None
        assert tinc.right_b_factor(tinc.HadSpec(had, K, n)) is None
    for n, B in ((4096, 128), (11008, 128), (32000, 128), (64, 64),
                 (8, 8)):
        spec = jinc.get_hadK(n, use_rand=False)
        tspec = tinc.get_hadK(n, use_rand=False)
        got = tinc.right_b_factor(tspec)
        want = jinc.right_b_factor(spec)
        assert got[1] == want[1] == min(B, spec.padN // spec.K)
        assert np.array_equal(got[0], want[0])


def _jlin(in_f, out_f, seed, per_channel=False, lspec=None, SU=None,
          rng=None):
    rng = rng or np.random.default_rng(seed)
    p = random_qlinear(jget_codebook("E8P12"), in_f, out_f, rng,
                       dtype=jnp.float32, lspec=lspec, SU=SU)
    if per_channel:
        p = dataclasses.replace(p, per_channel=True, Wscale=jnp.asarray(
            rng.uniform(0.5, 1.5, p.q_out).astype(np.float32)))
    return p


@pytest.fixture
def jax_right(monkeypatch):
    monkeypatch.setattr(JQL, "_RIGHT_IN_KERNEL", True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,per_channel", [((384, 256), False),
                                               ((256, 384), True),
                                               ((128, 64), False)])
@pytest.mark.parametrize("m", [3, 40])
def test_quant_linear_right_in_kernel(shape, per_channel, m, dtype,
                                      jax_right):
    """q_out 256 (B 128, H_A 2), 384 (use_rand: K 3, M 128) with the
    per-channel scale, and 64 (the dense route: no epilogue in either)."""
    in_f, out_f = shape
    jp = _jlin(in_f, out_f, seed=in_f + m, per_channel=per_channel)
    tp = qlinear_from_jax(jp, device="cpu")
    tp.right_in_kernel = True
    x = np.random.default_rng(m).standard_normal((m, in_f)).astype(
        np.float32)
    want = JQL.apply(jp, jnp.asarray(x), compute_dtype=getattr(jnp, dtype))
    got = tp(torch.from_numpy(x), compute_dtype=getattr(torch, dtype))
    _close_rel(got.float().numpy(), want, TOL[dtype])


@pytest.mark.parametrize("outs", [(128, 64, 64), (384, 384)])
@pytest.mark.parametrize("m", [1, 40])
def test_fused_quant_linear_right_in_kernel(outs, m, jax_right):
    """(128, 64, 64): qkv with GQA widths, not uniform, so no epilogue in
    either package; (384, 384): gate/up, uniform, finish_right with the
    stacked per-segment hadK."""
    rng = np.random.default_rng(sum(outs) + m)
    D = 128
    lspec = jinc.get_hadK(D, use_rand=True, rng=rng)
    su = np.sign(rng.standard_normal(D)).astype(np.float32)
    jps = [_jlin(D, o, 0, lspec=lspec, SU=su, rng=rng) for o in outs]
    jf = JQL.fuse_qlinears(jps)
    tf = TQL.fuse_qlinears([qlinear_from_jax(p, "cpu") for p in jps])
    tf.right_in_kernel = True
    x = rng.standard_normal((m, D)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        want = JQL.fused_apply(jf, jnp.asarray(x),
                               compute_dtype=getattr(jnp, dtype))
        got = tf(torch.from_numpy(x), compute_dtype=getattr(torch, dtype))
        for g, w in zip(got, want):
            _close_rel(g.float().numpy(), w, TOL[dtype])


DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


def test_tiny_llama_forward_right_in_kernel(jax_right):
    """A 2-layer llama (quantized head) carried across: the switch-on
    forward of each package at 12 and 40 tokens, and the port's switch-on
    logits against its switch-off logits."""
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    jparams = JM.fuse_for_inference(jcfg, params)
    for S in (12, 40):
        ids = np.random.default_rng(S).integers(0, 256, (1, S))
        TM.set_right_in_kernel(port, False)
        off, _ = TM.model_apply(tcfg, port, torch.from_numpy(ids))
        TM.set_right_in_kernel(port, True)
        on, _ = TM.model_apply(tcfg, port, torch.from_numpy(ids))
        jl, _ = JM.model_apply(jcfg, jparams, jnp.asarray(ids),
                               dtype=jnp.float32)
        jl, on, off = np.asarray(jl), on.numpy(), off.numpy()
        assert np.all(np.isfinite(on))
        err = np.abs(on - jl).max(axis=-1)
        assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err
        err = np.abs(on - off).max(axis=-1)
        assert np.all(err <= 2e-2 * np.abs(off).max(axis=-1)), err
    TM.set_right_in_kernel(port, False)


@pytest.mark.parametrize("layout", ["nibble", "bfp", "u3"])
def test_grads_through_right_hb_match_jax(layout):
    """x and scale gradients through the port's custom backward with
    right_hb (g times Hb in f32, then K3's twin) against jax.grad through
    the JAX custom VJP, both followed by finish_right."""
    q_out, q_in, m = 256, 1024, 5
    j, t = _tensors("E8P12", layout, q_out, q_in, seed=11)
    rng = np.random.default_rng(5)
    x = _x(m, t, seed=5)
    sv = rng.uniform(0.5, 1.5, q_out).astype(np.float32)
    g_out = rng.standard_normal((m, q_out)).astype(np.float32)
    spec = jinc.HadSpec(None, 1, q_out)
    tspec = tinc.HadSpec(None, 1, q_out)
    hb, _ = jinc.right_b_factor(spec)

    def jf(x, s):
        y = jdp.fused_quant_matmul_pre(x, j, scale_vec=s,
                                       right_hb=jnp.asarray(hb, jnp.float32))
        return (jinc.finish_right(y, spec) * jnp.asarray(g_out)).sum()

    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(sv))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(sv).requires_grad_(True)
    y = tfm.fused_quant_matmul_pre(tx, t, scale_vec=ts,
                                   right_hb=torch.from_numpy(
                                       np.asarray(hb, np.float32)))
    (tinc.finish_right(y, tspec) * torch.from_numpy(g_out)).sum().backward()
    for got, w in zip((tx.grad, ts.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
