"""The combined residual decode (``combine``, the JAX package's
QFA_COMBINE_PLANES) against the JAX package: E8P12RVQ4B and E8P12RVQ3B
planes in the nibble and sw layouts through each package's
``fused_quant_matmul_pre``, the JAX Pallas kernel in interpret mode under
``monkeypatch.setenv("QFA_COMBINE_PLANES", n)`` (read at every call), the
port's twin with ``combine=n``; with and without the right epilogue.
Where the padded m's Pallas block has more than n rows neither package
combines, and the port's result is the uncombined function's.

Tolerance: 1e-5 of the max plus one bf16 ulp of the element (bf16 x and
output; f32: the 1e-5 alone). With right_hb, plus |Hb| times the two
packages' difference without it (a first rounding that lands on a
neighbouring bf16 value is carried by the B x B product).
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
from quip_for_all_tpu_torch.ops import qtensor as tqt

pytestmark = pytest.mark.fast

Q_OUT, Q_IN = 256, 1024


@pytest.fixture(autouse=True, scope="module")
def one_thread():
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


def _tensors(cb, layout, seed):
    rng = np.random.default_rng(seed)
    bits = 24 if cb == "E8P12RVQ3B" else 32
    raw = (rng.integers(0, 1 << bits, (Q_OUT, Q_IN // 8), dtype=np.uint64)
           .astype(np.uint32).view(np.int32))
    j = jqt.from_raw_idxs(jget_codebook(cb), raw, Q_OUT, Q_IN, layout=layout)
    t = tqt.from_raw_idxs(get_codebook(cb), raw, Q_OUT, Q_IN, device="cpu",
                          layout=layout)
    return j, t


def _run(j, t, m, n, dtype, hb, monkeypatch, seed):
    x = np.random.default_rng(seed).standard_normal((m, Q_IN)).astype(
        np.float32)
    xg = tfm.grouped_permute(torch.from_numpy(x), t.group_cols,
                             t.split).numpy()
    scale = np.random.default_rng(seed + 1).uniform(0.5, 1.5, Q_OUT).astype(
        np.float32)
    monkeypatch.setenv("QFA_COMBINE_PLANES", str(n))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo = jdp.fused_quant_matmul_pre(
        jnp.asarray(xg).astype(jdt), j, scale_vec=jnp.asarray(scale),
        right_hb=None if hb is None else jnp.asarray(hb, jnp.float32))
    to = tfm.fused_quant_matmul_pre(
        torch.from_numpy(xg).to(tdt), t, scale_vec=torch.from_numpy(scale),
        combine=n,
        right_hb=None if hb is None else torch.from_numpy(
            np.asarray(hb, np.float32)))
    return np.asarray(jo.astype(jnp.float32)), to.float().numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,n", [(1, 2), (2, 2), (8, 8), (1, 8), (2, 8)])
@pytest.mark.parametrize("layout", ["nibble", "sw2", "sw4"])
@pytest.mark.parametrize("cb", ["E8P12RVQ4B", "E8P12RVQ3B"])
def test_combined_twin_matches_pallas(cb, layout, m, n, dtype, monkeypatch):
    j, t = _tensors(cb, layout, seed=m + n)
    assert tfm.combine_applies(t, max(8, m), n) == (n >= 8)
    jo, to = _run(j, t, m, n, dtype, None, monkeypatch, seed=m)
    assert_close(to, jo, dtype)


@pytest.mark.parametrize("m,n", [(1, 8), (8, 8), (40, 8)])
@pytest.mark.parametrize("cb", ["E8P12RVQ4B", "E8P12RVQ3B"])
def test_combined_twin_with_right_hb(cb, m, n, monkeypatch):
    """The combined branch with the right epilogue (``_make_kernel``
    applies both), at the 1-D grid (m 1, 8) and at m 40, whose Pallas
    blocks of 8 rows combine on the 2-D grid (K2 on a card)."""
    j, t = _tensors(cb, "nibble", seed=m)
    assert tfm.combine_applies(t, m if m % 8 == 0 else 8, n)
    hb, _ = jinc.right_b_factor(jinc.HadSpec(None, 1, Q_OUT))
    j0, t0 = _run(j, t, m, n, "bfloat16", None, monkeypatch, seed=m)
    jr, tr = _run(j, t, m, n, "bfloat16", hb, monkeypatch, seed=m)
    d = np.abs(t0 - j0).reshape(m, -1, 128) @ np.abs(hb).T
    assert_close(tr, jr, "bfloat16", d.reshape(m, Q_OUT))


@pytest.mark.parametrize("cb", ["E8P12RVQ4B", "E8P12RVQ3B"])
def test_above_the_bound_is_the_uncombined_function(cb, monkeypatch):
    """m 32 with n 8: the Pallas block has 32 rows, so neither package
    combines, and the port's result is bit-equal to its twin without
    combine."""
    j, t = _tensors(cb, "nibble", seed=5)
    assert not tfm.combine_applies(t, 32, 8)
    jo, to = _run(j, t, 32, 8, "bfloat16", None, monkeypatch, seed=5)
    assert_close(to, jo, "bfloat16")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (32, 8 * t.group_cols)).astype(np.float32)).bfloat16()
    assert torch.equal(tfm.fused_quant_matmul_pre(x, t, combine=8),
                       tfm.fused_quant_matmul_pre(x, t))


def test_combine_needs_two_plane_sets_outside_split_k():
    """One plane set, the bfp layout and split-K never combine, as the JAX
    bodies (``_make_kernel_bfp`` and ``_make_kernel_ksplit`` have no
    combined branch)."""
    _, t = _tensors("E8P12RVQ4B", "nibble", seed=1)
    _, tb = _tensors("E8P12RVQ4B", "bfp", seed=1)
    e8 = tqt.from_raw_idxs(get_codebook("E8P12"),
                           np.zeros((Q_OUT, Q_IN // 8), np.int32), Q_OUT,
                           Q_IN, device="cpu")
    assert tfm.combine_applies(t, 8, 8)
    assert not tfm.combine_applies(t, 8, 8, chunks=2)
    assert not tfm.combine_applies(tb, 8, 8)
    assert not tfm.combine_applies(e8, 8, 8)
    assert not tfm.combine_applies(t, 8, 0)
