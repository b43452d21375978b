"""The port's quantization primitives against the JAX package on the CPU:
the numpy-Generator Hadamard factors, nearest-codeword rounding of all five
codebooks, Hessians, block LDL, LDLQ and ``quantize_layer`` with its packed
``QuantLinear``.

Tolerances (the same inputs from numpy seeds; the two packages sum in
other orders): sign vectors and Hadamard factors bitwise; codes equal;
Hessians within 1e-6 of max|H|; block LDL within 1e-5; LDLQ's hatW within
1e-4; w_scale within 1e-6 relative; W_hat within 1e-4 of max|W|; the
packed layer's f32 forward within 1e-5 of max plus one f32 ulp
(``tests/torch_family_cases.py`` ``assert_close``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.nn import qlinear as JQL
from quip_for_all_tpu.quantize import hessian as jhess
from quip_for_all_tpu.quantize import ldlq as jldlq
from quip_for_all_tpu.quantize import quip as jquip
from quip_for_all_tpu.transforms import incoherence as jinc

from quip_for_all_tpu_torch.codebooks import base as tbase
from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.quantize import hessian as thess
from quip_for_all_tpu_torch.quantize import ldlq as tldlq
from quip_for_all_tpu_torch.quantize import quip as tquip
from quip_for_all_tpu_torch.transforms import incoherence as tinc

from torch_family_cases import assert_close

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor ops (an LDLQ loop): one thread a test worker, so
    that a parallel test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CODEBOOKS = ["E8P12", "D4", "HI", "E8P12RVQ4B", "E8P12RVQ3B"]


def _hess(n, rows=512, seed=0):
    X = np.random.default_rng(seed).standard_normal((rows, n)).astype(
        np.float32)
    return (X.T @ X / rows).astype(np.float32)


@pytest.mark.parametrize("n", [96, 384, 11008, 4096])
def test_numpy_generator_factor_is_bitwise_jax(n):
    ja, ta = np.random.default_rng(n), np.random.default_rng(n)
    js = jinc.get_hadK(n, use_rand=True, rng=ja)
    ts = tinc.get_hadK(n, use_rand=True, rng=ta)
    assert (js.K, js.padN) == (ts.K, ts.padN)
    if js.hadK is None:
        assert ts.hadK is None
    else:
        assert isinstance(ts.hadK, np.ndarray) and ts.hadK.dtype == np.float32
        assert np.array_equal(np.asarray(js.hadK), ts.hadK)
    # the generators were drawn alike
    assert ja.standard_normal() == ta.standard_normal()


def test_sharded_transforms_raise_naming_the_queue():
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tinc.get_hadK(256, use_rand=True, rng=np.random.default_rng(0),
                      shards=2)


@pytest.mark.parametrize("name", CODEBOOKS)
def test_quantize_indices_equal_jax(name):
    jcb, tcb = jget_codebook(name), get_codebook(name)
    assert (tcb.opt_scale, tcb.idx_dtype, tcb.codesz) == (
        jcb.opt_scale, jcb.idx_dtype, jcb.codesz)
    X = (np.random.default_rng(1).standard_normal((384, jcb.codesz))
         * 1.7).astype(np.float32)
    jv, ji = jcb.quantize(jnp.asarray(X))
    tv, ti = tcb.quantize(torch.from_numpy(X))
    assert ti.dtype == torch.int32
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
    packed = tcb.pack_idxs(ti.numpy().reshape(16, -1))
    assert np.array_equal(packed, jcb.pack_idxs(np.asarray(ji).reshape(
        16, -1)))
    assert np.array_equal(tcb.unpack_idxs(packed),
                          jcb.unpack_idxs(packed))


@pytest.mark.parametrize("chunk", ["jax", "card"])
def test_e8p12_rounding_at_both_chunks(chunk):
    """The port's chunk on the card (``card_chunk``: the whole 65536-row
    grid at these rows) gives JAX's indices too: first index on ties,
    strictly greater across chunks."""
    X = np.random.default_rng(2).standard_normal((512, 8)).astype(
        np.float32)
    # exact ties: rows that are codewords plus halfway points
    g = get_codebook("E8P12").grid()
    X[:64] = g[np.random.default_rng(3).integers(0, 65536, 64)]
    X[64:96] = 0.5 * (g[:32] + g[32:64])
    c = (tbase.ARGMAX_CHUNK if chunk == "jax"
         else tbase.card_chunk(512, 65536))
    assert (c == 65536) == (chunk == "card")
    _, ji = jget_codebook("E8P12").quantize(jnp.asarray(X))
    _, ti = get_codebook("E8P12").quantize(torch.from_numpy(X), chunk=c)
    assert np.array_equal(np.asarray(ji), ti.numpy())


def test_rvq4b_codes_wrap_as_int32():
    """main << 16 wraps in JAX's int32: the port makes the same bits."""
    X = np.full((4, 8), -2.0, np.float32)
    _, ji = jget_codebook("E8P12RVQ4B").quantize(jnp.asarray(X))
    _, ti = get_codebook("E8P12RVQ4B").quantize(torch.from_numpy(X))
    assert np.array_equal(np.asarray(ji), ti.numpy())
    X = np.random.default_rng(4).standard_normal((256, 8)).astype(
        np.float32) * 2
    _, ti = get_codebook("E8P12RVQ4B").quantize(torch.from_numpy(X))
    _, ji = jget_codebook("E8P12RVQ4B").quantize(jnp.asarray(X))
    assert (ti < 0).any() and np.array_equal(np.asarray(ji), ti.numpy())


def test_hessian_finalize_matches():
    rng = np.random.default_rng(5)
    n = 96
    js = jhess.HessianState.zeros(n)
    ts = thess.HessianState.zeros(n)
    for _ in range(4):
        x = (rng.standard_normal((3, 17, n)) * 3 + 1).astype(np.float32)
        js = jhess.accumulate(js, jnp.asarray(x))
        thess.accumulate(ts, torch.from_numpy(x))
    jH = np.asarray(jhess.finalize(js))
    tH = thess.finalize(ts)
    assert tH.dtype == torch.float32 and ts.count == 4 * 51
    assert np.abs(tH.numpy() - jH).max() <= 1e-6 * np.abs(jH).max()


def _chol(H):
    return np.linalg.cholesky(H.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("g", [1, 4, 8])
def test_block_ldl_matches(g):
    L = _chol(_hess(64) + 0.01 * np.eye(64, dtype=np.float32))
    want = np.asarray(jldlq.block_ldl(jnp.asarray(L), g))
    got = tldlq.block_ldl(torch.from_numpy(L), g).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("name", ["D4", "E8P12", "E8P12RVQ4B", "HI"])
@pytest.mark.parametrize("iters", [0, 2])
@pytest.mark.parametrize("m,n", [(16, 32), (32, 64)])
def test_ldlq_matches(name, iters, m, n):
    H = _hess(n, seed=m) + 0.01 * np.eye(n, dtype=np.float32)
    L = _chol(H)
    W = np.random.default_rng(n + m).standard_normal((m, n)).astype(
        np.float32)
    jw, ji = jldlq.ldlq(jnp.asarray(W), jnp.asarray(H), jnp.asarray(L),
                        jget_codebook(name), iters)
    tw, ti = tldlq.ldlq(torch.from_numpy(W), torch.from_numpy(H),
                        torch.from_numpy(L), get_codebook(name), iters)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.abs(tw.numpy() - np.asarray(jw)).max() <= 1e-4


LAYER_CASES = {
    # name: (codebook, (out, in), QuantConfig kwargs)
    "e8p12": ("E8P12", (96, 192), {}),
    "e8p12_per_channel": ("E8P12", (128, 256), {"per_channel": True}),
    "e8p12_rescale": ("E8P12", (64, 128), {"rescale_WH": True}),
    "e8p12_table": ("E8P12", (64, 96), {"use_rand": False}),
    "e8p12_scale_override": ("E8P12", (64, 64), {"scale_override": 0.9}),
    "rvq4b": ("E8P12RVQ4B", (64, 128), {}),
    "rvq3b": ("E8P12RVQ3B", (64, 128), {}),
    "d4": ("D4", (48, 96), {"rescale_WH": True}),
    "hi": ("HI", (40, 64), {}),
}


def _run_layer(cb, shape, kw, seed=7, H=None, W=None, **call):
    n_out, n_in = shape
    H = _hess(n_in, seed=seed) if H is None else H
    W = (np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) if W is None else W)
    ja, jw = jquip.quantize_layer(
        W, H, jget_codebook(cb), jquip.QuantConfig(quip_tune_iters=2, **kw),
        np.random.default_rng(seed), **call)
    ta, tw = tquip.quantize_layer(
        W, H, get_codebook(cb), tquip.QuantConfig(quip_tune_iters=2, **kw),
        np.random.default_rng(seed), device="cpu", **call)
    return W, ja, jw, ta, tw


def _check_attrs(W, ja, jw, ta, tw):
    assert np.array_equal(ja.SU, ta.SU) and np.array_equal(ja.SV, ta.SV)
    for js, ts in ((ja.left_spec, ta.left_spec),
                   (ja.right_spec, ta.right_spec)):
        assert (js.K, js.padN) == (ts.K, ts.padN)
        assert (js.hadK is None and ts.hadK is None) or np.array_equal(
            np.asarray(js.hadK), np.asarray(ts.hadK))
    assert np.array_equal(ja.Qidxs_raw, ta.Qidxs_raw)
    assert ta.Qidxs_raw.dtype == np.int32
    assert ja.w_scale.shape == ta.w_scale.shape
    assert np.all(np.abs(ta.w_scale - ja.w_scale)
                  <= 1e-6 * np.abs(ja.w_scale))
    assert (ja.merge_su, ja.merge_sv) == (ta.merge_su, ta.merge_sv)
    assert (ja.scaleWH is None) == (ta.scaleWH is None)
    assert np.abs(tw.numpy() - jw).max() <= 1e-4 * np.abs(W).max()


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_quantize_layer_matches(case):
    cb, shape, kw = LAYER_CASES[case]
    W, ja, jw, ta, tw = _run_layer(cb, shape, kw)
    _check_attrs(W, ja, jw, ta, tw)
    pc = kw.get("per_channel", False)
    bias = np.random.default_rng(1).standard_normal(shape[0]).astype(
        np.float32)
    jp = jquip.pack_to_qlinear(ja, jget_codebook(cb), bias=bias,
                               per_channel=pc)
    tp = tquip.pack_to_qlinear(ta, get_codebook(cb), bias=bias,
                               per_channel=pc, device="cpu")
    assert (tp.SU is None) == (jp.SU is None)
    assert tp.wscale_float == pytest.approx(float(jp.wscale_float),
                                            rel=1e-6)
    x = np.random.default_rng(2).standard_normal((5, shape[1])).astype(
        np.float32)
    want = JQL.apply(jp, jnp.asarray(x), compute_dtype=jnp.float32)
    got = tp(torch.from_numpy(x), compute_dtype=torch.float32)
    assert_close(got.numpy(), want)


def test_merged_signs_and_dead_columns():
    """Merged SU/SV (the merge_suv path: both dropped at pack, the bias
    divided by SV) and a Hessian with dead columns (patched to 1 on the
    diagonal, their weights zeroed)."""
    n_in, n_out = 128, 64
    H = _hess(n_in, seed=3)
    H[:, [5, 77]] = 0.0
    H[[5, 77], :] = 0.0
    rng = np.random.default_rng(9)
    SU = np.sign(rng.standard_normal(n_in)).astype(np.float32)
    SV = np.sign(rng.standard_normal(n_out)).astype(np.float32)
    W, ja, jw, ta, tw = _run_layer("E8P12", (n_out, n_in), {}, H=H, SU=SU,
                                   SV=SV)
    _check_attrs(W, ja, jw, ta, tw)
    assert ta.merge_su and ta.merge_sv
    bias = np.ones(n_out, np.float32)
    tp = tquip.pack_to_qlinear(ta, get_codebook("E8P12"), bias=bias,
                               device="cpu")
    assert tp.SU is None and tp.SV is None
    assert torch.equal(tp.bias, torch.from_numpy(bias / SV))


def test_cholesky_escalates_from_the_first_attempt():
    """An indefinite Hessian: sigma_reg goes onto the diagonal before each
    attempt, and the attempt that succeeds is JAX's."""
    n = 64
    H = _hess(n, seed=4)
    H /= np.mean(np.diag(H))
    # smallest eigenvalue about -0.02 once normalized: the third attempt
    # (3 x sigma_reg on the diagonal) is the first that factors
    H -= (np.linalg.eigvalsh(H).min() + 0.015) * np.eye(n, dtype=np.float32)
    W, ja, jw, ta, tw = _run_layer("D4", (32, n), {}, H=H)
    _check_attrs(W, ja, jw, ta, tw)
    with pytest.raises(ValueError, match="not invertible"):
        tquip.quantize_layer(
            W, np.diag([1.0] * (n - 1) + [-60.0]).astype(np.float32),
            get_codebook("D4"),
            tquip.QuantConfig(), np.random.default_rng(0), device="cpu")


def test_full_f32_inside_a_quantize_call(monkeypatch):
    """TF32 off and the float32 matmul precision "highest" while a layer
    quantizes; the caller's settings come back afterwards."""
    seen = []
    cb = get_codebook("E8P12")
    orig = type(cb).quantize

    def spy(self, X, chunk=None):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return orig(self, X, chunk)
    monkeypatch.setattr(type(cb), "quantize", spy)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        tquip.quantize_layer(np.ones((16, 32), np.float32), _hess(32), cb,
                             tquip.QuantConfig(quip_tune_iters=1),
                             np.random.default_rng(0), device="cpu")
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    assert seen and set(seen) == {(False, "highest")}
    assert after == (True, "high")


def test_proxy_loss():
    W = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    H = torch.from_numpy(_hess(16))
    assert tquip.proxy_loss(W, W, H) == 0.0
    assert tquip.proxy_loss(W, torch.zeros_like(W), H) == pytest.approx(1.0)
