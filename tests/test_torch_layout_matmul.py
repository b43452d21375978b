"""The plain twins of the bfp (K10), sw2/sw4 (K11), paired (K7) and split-K
(K6) kernels against the JAX package's Pallas kernels, run in interpret
mode as the JAX tests run them, through each package's
``fused_quant_matmul_pre``; and the sw lane order of the grouped prologue.

On the CPU the wrappers take the plain twins; on a card the kernels are
held against the same twins in tests/test_torch_layout_cuda.py.

Planes come from random valid codes (``from_raw_idxs`` in both packages);
x is zero on the pad lanes. Rows m = 1, 8, 32, 40 and 64 cover both
``_fused_call`` grids and the paired group-sum rounding (bf16 at m = 32
and 64, f32 at m <= 8 and at m = 40, whose Pallas blocks have 8 rows).
Split-K (QFA_KSPLIT in the JAX package, read at call time) runs at Gp 256
(2 and 4 requested: 2 chunks) and Gp 384 (3 lane blocks: 2 falls back to
one chunk, 3 and 4 split 3 ways); above a padded m of 32 both packages
take the unsplit kernel.

Tolerance: 1 bf16 ulp of the element + 1e-5 of the max (f32 outputs: the
1e-5 alone). Products are exact at bf16 x; sums differ in order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops import qtensor as jqt
from quip_for_all_tpu.transforms import incoherence as jinc

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops import layout_matmul as tlm
from quip_for_all_tpu_torch.ops import qtensor as tqt
from quip_for_all_tpu_torch.ops import rowpair_matmul as trm
from quip_for_all_tpu_torch.transforms import incoherence as tinc

pytestmark = pytest.mark.fast

Q_OUT = 128


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got: np.ndarray, want: np.ndarray, dtype: str):
    tol = 1e-5 * np.abs(want).max()
    if dtype == "bfloat16":
        tol = tol + bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _tensors(cb, layout, q_in, seed):
    rng = np.random.default_rng(seed)
    if cb == "E8P12":
        raw = rng.integers(0, 1 << 16, (Q_OUT, q_in // 8)).astype(np.int32)
    else:
        raw = (rng.integers(0, 1 << 62, (Q_OUT, q_in // 8), dtype=np.uint64)
               .astype(np.uint32).view(np.int32))
    j = jqt.from_raw_idxs(jget_codebook(cb), raw, Q_OUT, q_in, layout=layout)
    t = tqt.from_raw_idxs(get_codebook(cb), raw, Q_OUT, q_in, device="cpu",
                          layout=layout)
    return j, t


def _x(m, t, seed):
    """x in the tensor's grouped lane order, pad lanes zero."""
    x = np.random.default_rng(seed).standard_normal((m, t.q_in)).astype(
        np.float32)
    return tfm.grouped_permute(torch.from_numpy(x), t.group_cols,
                               t.split).numpy()


def _pallas(j, x, dtype, scale):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out = jdp.fused_quant_matmul_pre(
        jnp.asarray(x).astype(jdt), j,
        scale_vec=None if scale is None else jnp.asarray(scale))
    return np.asarray(out.astype(jnp.float32))


def _port(t, x, dtype, scale, plain=False, ksplit=0):
    tdt = getattr(torch, dtype)
    out = tfm.fused_quant_matmul_pre(
        torch.from_numpy(x).to(tdt), t,
        scale_vec=None if scale is None else torch.from_numpy(scale),
        plain=plain, ksplit=ksplit)
    assert out.dtype == tdt and out.shape == (x.shape[0], Q_OUT)
    return out.float().numpy()


def _scale(seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, Q_OUT).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 32, 40, 64])
@pytest.mark.parametrize("cb,layout", [
    ("E8P12", "bfp"), ("E8P12RVQ4B", "bfp"), ("E8P12", "sw2"),
    ("E8P12RVQ4B", "sw2"), ("E8P12", "sw4"), ("E8P12RVQ4B", "sw4"),
    ("E8P12RVQ4B", "paired")])
def test_plain_twin_matches_pallas(cb, layout, m, dtype):
    """bfp and sw with 1 and 2 plane sets, paired (q_in 2048, Gp 256)."""
    j, t = _tensors(cb, layout, 2048, seed=m)
    x = _x(m, t, seed=m + 1)
    scale = _scale(m)
    want = _pallas(j, x, dtype, scale)
    got = _port(t, x, dtype, scale)
    assert_close(got, want, dtype)
    # the plain route is the same twin on any device
    assert np.array_equal(_port(t, x, dtype, scale, plain=True), got)


def test_paired_bf16_group_sum_is_what_pallas_rounds(monkeypatch):
    """At m = 32 in bf16 the Pallas paired body sums the groups in bf16, at
    the down_proj width (Gp 1536). A twin that summed them in f32 leaves
    the tolerance on this input; the port's twin matches to it."""
    j, t = _tensors("E8P12RVQ4B", "paired", 1376 * 8, seed=21)
    x = _x(32, t, seed=22)
    want = _pallas(j, x, "bfloat16", None)
    assert_close(_port(t, x, "bfloat16", None), want, "bfloat16")
    monkeypatch.setattr(trm, "group_sum_in_bf16", lambda x_perm: False)
    with pytest.raises(AssertionError):
        assert_close(_port(t, x, "bfloat16", None), want, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 32, 40, 64])
@pytest.mark.parametrize("q_in,ksplit", [(2048, 2), (2048, 4), (3072, 2),
                                         (3072, 3)])
def test_ksplit_twin_matches_pallas(q_in, ksplit, m, dtype, monkeypatch):
    """Split-K under QFA_KSPLIT, E8P12 nibble planes with scale_vec; at
    m = 40 and 64 (padded m > 32) both packages take the unsplit kernel."""
    monkeypatch.setenv("QFA_KSPLIT", str(ksplit))
    j, t = _tensors("E8P12", None, q_in, seed=q_in + m)
    x = _x(m, t, seed=m + 2)
    scale = _scale(m + 3)
    want = _pallas(j, x, dtype, scale)
    got = _port(t, x, dtype, scale, ksplit=ksplit)
    assert_close(got, want, dtype)
    assert np.array_equal(_port(t, x, dtype, scale, plain=True,
                                ksplit=ksplit), got)


def test_ksplit_chunk_rule_matches_jax():
    for req in range(0, 13):
        for Gp in (128, 256, 384, 512, 1408, 1536, 100):
            assert tlm.pick_ksplit(req, Gp) == jdp._pick_ksplit(req, Gp)
    assert tlm.pick_ksplit(4, 1408) == 1 and tlm.pick_ksplit(11, 1408) == 11


def test_ksplit_takes_the_split_kernel_only_where_jax_does(monkeypatch):
    """Which twin runs: split-K at padded m <= 32 with > 1 chunk on nibble
    planes; K1's twin otherwise (and for sw / bfp planes)."""
    calls = []
    monkeypatch.setattr(tfm, "ksplit_decode_matmul_ref",
                        lambda *a, **k: calls.append("K6") or
                        tlm.ksplit_decode_matmul_ref(*a, **k))
    _, t = _tensors("E8P12", None, 2048, seed=5)
    for m in (1, 32, 33):
        x = _x(m, t, seed=m)
        _port(t, x, "float32", None, plain=True, ksplit=2)
        _port(t, x, "float32", None, plain=True, ksplit=0)
    _, s = _tensors("E8P12", "sw2", 2048, seed=6)
    _port(s, _x(1, s, seed=1), "float32", None, plain=True, ksplit=2)
    assert calls == ["K6", "K6"]


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("n", [512, 1024 * 3])
def test_grouped_prologue_lane_order_matches_jax(n, P):
    """matmul_hadUt_grouped(split=P) and grouped_permute(split=P) give
    JAX's lane order (a 3x1024 input has a table hadK factor)."""
    rng = np.random.default_rng(n + P)
    js = jinc.get_hadK(n, use_rand=False)
    ts = tinc.get_hadK(n, use_rand=False)
    x = rng.standard_normal((3, n)).astype(np.float32)
    Gp = -(-(n // 8) // 128) * 128 + 128
    want = np.asarray(jinc.matmul_hadUt_grouped(jnp.asarray(x), js, Gp,
                                                scale=0.3, split=P))
    got = tinc.matmul_hadUt_grouped(torch.from_numpy(x), ts, Gp, scale=0.3,
                                    split=P).numpy()
    assert got.shape == want.shape == (3, 8 * Gp)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # natural-order x through the kernel entry's permutation, as JAX's
    # fused_quant_matmul lays it out (q*(P*Gp) + P*g + j)
    G, nq = n // 8, 8 // P
    ref = np.zeros((3, nq, Gp, P), np.float32)
    ref[:, :, :G, :] = x.reshape(3, G, P, nq).transpose(0, 3, 1, 2)
    assert np.array_equal(
        tfm.grouped_permute(torch.from_numpy(x), Gp, P).numpy(),
        ref.reshape(3, 8 * Gp))


@pytest.mark.parametrize("cb,layout", [("E8P12", "sw4"),
                                       ("E8P12RVQ4B", "paired"),
                                       ("E8P12", "bfp")])
def test_natural_order_entry_matches_pallas(cb, layout):
    """fused_quant_matmul permutes natural-order x at the layout's Gp and
    split (m = 3)."""
    j, t = _tensors(cb, layout, 2048, seed=30)
    x = np.random.default_rng(3).standard_normal((3, 2048)).astype(
        np.float32)
    want = np.asarray(jdp.fused_quant_matmul(jnp.asarray(x), j))
    got = tfm.fused_quant_matmul(torch.from_numpy(x), t).numpy()
    assert_close(got, want, "float32")


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, b = _tensors("E8P12", "bfp", 2048, seed=40)
    _, s = _tensors("E8P12", "sw2", 2048, seed=41)
    _, n = _tensors("E8P12", None, 2048, seed=42)
    aff = ((0.5, -2.75),)
    x = torch.zeros(8, 8 * 256)
    with pytest.raises(ValueError):        # width != 8*Gp
        tlm.bfp_decode_matmul(torch.zeros(8, 64), b.plane_list(), aff)
    with pytest.raises(TypeError):         # dtype
        tlm.sw_decode_matmul(x.half(), s.plane_list(), aff)
    with pytest.raises(ValueError):        # nibble planes on the sw kernel
        tlm.sw_decode_matmul(x, n.plane_list(), aff)
    with pytest.raises(ValueError):        # sw planes on the bfp kernel
        tlm.bfp_decode_matmul(x, s.plane_list(), aff)
    with pytest.raises(ValueError):        # rows past x
        tlm.ksplit_decode_matmul(x, n.plane_list(), aff, 2, rows=9)
    with pytest.raises(ValueError):        # 3 chunks do not divide Gp 256
        tlm.ksplit_decode_matmul(x, n.plane_list(), aff, 3)
    with pytest.raises(ValueError):        # scale of the wrong length
        tlm.bfp_decode_matmul(x, b.plane_list(), aff,
                              scale_vec=torch.ones(Q_OUT + 2))
    with pytest.raises(RuntimeError):      # no kernel for this device
        tlm.ksplit_decode_matmul(
            torch.zeros(8, 8 * 256, device="meta"),
            [n.planes["w0"].to("meta")], aff, 2)
    _, p = _tensors("E8P12RVQ4B", "paired", 2048, seed=43)
    with pytest.raises(ValueError):        # pb-shaped planes as paired
        trm.paired_decode_matmul(x, {"w0": p.planes["w0"][:64],
                                     "w1": p.planes["w1"],
                                     "w2": p.planes["w2"]}, 0.3)


def test_cpu_tensors_take_the_plain_twins_and_count_no_launch():
    counters = (tlm.bfp_decode_matmul, tlm.sw_decode_matmul,
                tlm.ksplit_decode_matmul, trm.paired_decode_matmul)
    before = [c.launches for c in counters]
    aff = ((0.5, -2.75),)
    _, b = _tensors("E8P12", "bfp", 2048, seed=50)
    _, s = _tensors("E8P12", "sw4", 2048, seed=51)
    _, n = _tensors("E8P12", None, 2048, seed=52)
    _, p = _tensors("E8P12RVQ4B", "paired", 2048, seed=53)
    x = torch.randn(8, 8 * 256)
    assert torch.equal(tlm.bfp_decode_matmul(x, b.plane_list(), aff, rows=3),
                       tlm.bfp_decode_matmul_ref(x[:3], b.plane_list(), aff))
    assert torch.equal(tlm.sw_decode_matmul(x, s.plane_list(), aff),
                       tlm.sw_decode_matmul_ref(x, s.plane_list(), aff))
    assert torch.equal(
        tlm.ksplit_decode_matmul(x, n.plane_list(), aff, 2),
        tlm.ksplit_decode_matmul_ref(x, n.plane_list(), aff, 2))
    rs = p.opt_resid_scale
    assert torch.equal(trm.paired_decode_matmul(x, p.planes, rs),
                       trm.rowpair_matmul_ref(x, "paired", p.planes, rs))
    assert [c.launches for c in counters] == before
