"""The plain twins of the row-pair kernels (ops/rowpair_matmul.py: u3 K9,
pb K8) against the JAX package's Pallas kernels, run in interpret mode as
the JAX tests run them, through each package's ``fused_quant_matmul_pre``.

On the CPU the wrappers take the plain twins; on a card the kernels are
held against the same twins in tests/test_torch_rowpair_cuda.py.

Planes are random bits (u up to 7, as the JAX random builders make them)
at the ``down_proj`` width 1376*8 (u3 Gp 1536 with 12 parity fields; pb Gp
1408 with a ragged last parity field), x zero on the pad lanes. Rows m =
1, 8, 32, 40 and 64 cover both ``_fused_call`` grids and the group-sum
rounding: m <= 8 sums the groups in f32; m = 32 and 64 at bf16 sum them in
bf16; m = 40 pads to 40 rows, whose 8-row Pallas blocks go back to f32.

Tolerance: 1 bf16 ulp of the element + 1e-5 of the max (f32 outputs: the
1e-5 alone). Products are exact at bf16 x; sums differ in order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops.qtensor import QuantizedTensor as JQT
from quip_for_all_tpu.utils.random_quantized import random_plane_shapes

from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops import rowpair_matmul as trm
from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor as TQT

pytestmark = pytest.mark.fast

Q_OUT, Q_IN = 128, 1376 * 8
RS = 1 / 3.45
CB = {"u3": "E8P12", "pb": "E8P12RVQ4B"}


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got: np.ndarray, want: np.ndarray, dtype: str):
    tol = 1e-5 * np.abs(want).max()
    if dtype == "bfloat16":
        tol = tol + bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _tensors(layout, seed):
    rng = np.random.default_rng(seed)
    cb = CB[layout]
    shapes = random_plane_shapes(cb, layout, Q_OUT, Q_IN)
    planes = {k: rng.integers(-(1 << 31), 1 << 31, s, dtype=np.int64)
              .astype(np.int32) for k, s in shapes.items()}
    ors = RS if layout == "pb" else -1.0
    j = JQT({k: jnp.asarray(v) for k, v in planes.items()}, cb, Q_OUT, Q_IN,
            ors, layout=layout)
    t = TQT({k: torch.from_numpy(v) for k, v in planes.items()}, cb, Q_OUT,
            Q_IN, ors, layout=layout)
    return j, t


def _x(m, Gp, seed):
    x = np.random.default_rng(seed).standard_normal((m, 8, Gp)).astype(
        np.float32)
    x[:, :, Q_IN // 8:] = 0.0
    return x.reshape(m, 8 * Gp)


def _pallas(j, x, dtype, scale, monkeypatch, halfdots="0"):
    monkeypatch.setenv("QFA_U3_HALFDOTS", halfdots)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out = jdp.fused_quant_matmul_pre(
        jnp.asarray(x).astype(jdt), j,
        scale_vec=None if scale is None else jnp.asarray(scale))
    return np.asarray(out.astype(jnp.float32))


def _port(t, x, dtype, scale, plain=False):
    tdt = getattr(torch, dtype)
    out = tfm.fused_quant_matmul_pre(
        torch.from_numpy(x).to(tdt), t,
        scale_vec=None if scale is None else torch.from_numpy(scale),
        plain=plain)
    assert out.dtype == tdt and out.shape == (x.shape[0], Q_OUT)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 32, 40, 64])
@pytest.mark.parametrize("layout", ["u3", "pb"])
def test_plain_twin_matches_pallas(layout, m, dtype, monkeypatch):
    j, t = _tensors(layout, seed=m)
    x = _x(m, t.group_cols, seed=m + 1)
    scale = np.random.default_rng(m).uniform(0.5, 1.5, Q_OUT).astype(
        np.float32)
    want = _pallas(j, x, dtype, scale, monkeypatch)
    got = _port(t, x, dtype, scale)
    assert_close(got, want, dtype)
    # the plain route is the same twin on any device
    assert np.array_equal(_port(t, x, dtype, scale, plain=True), got)


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("halfdots", ["0", "1"])
def test_u3_twin_matches_both_pallas_dot_forms(halfdots, m, monkeypatch):
    """The Pallas u3 body has two dot forms (QFA_U3_HALFDOTS); the port
    implements one sum and holds it against both."""
    j, t = _tensors("u3", seed=10 + m)
    x = _x(m, t.group_cols, seed=11)
    want = _pallas(j, x, "bfloat16", None, monkeypatch, halfdots)
    assert_close(_port(t, x, "bfloat16", None), want, "bfloat16")


@pytest.mark.parametrize("layout", ["u3", "pb"])
def test_bf16_group_sum_is_what_pallas_rounds(layout, monkeypatch):
    """At m = 32 in bf16 the Pallas body sums the groups in bf16. A twin
    that summed them in f32 would leave the tolerance on this input; the
    port's twin matches to it."""
    j, t = _tensors(layout, seed=21)
    x = _x(32, t.group_cols, seed=22)
    want = _pallas(j, x, "bfloat16", None, monkeypatch)
    assert_close(_port(t, x, "bfloat16", None), want, "bfloat16")
    monkeypatch.setattr(trm, "group_sum_in_bf16", lambda x_perm: False)
    with pytest.raises(AssertionError):
        assert_close(_port(t, x, "bfloat16", None), want, "bfloat16")


def test_group_sum_rule_follows_the_pallas_blocks():
    def rule(mp, dtype=torch.bfloat16):
        return trm.group_sum_in_bf16(torch.zeros((mp, 8), dtype=dtype))
    assert [trm.pallas_block_rows(mp) for mp in (8, 16, 24, 32, 40, 64)] \
        == [8, 16, 24, 32, 8, 32]
    assert [rule(mp) for mp in (8, 16, 32, 40, 48, 64)] == [
        False, True, True, False, True, True]
    assert not rule(32, torch.float32)


@pytest.mark.parametrize("layout", ["u3", "pb"])
@pytest.mark.parametrize("m", [3, 40])
def test_natural_order_entry_matches_pallas(layout, m):
    """fused_quant_matmul permutes natural-order x at the layout's Gp."""
    j, t = _tensors(layout, seed=30 + m)
    x = np.random.default_rng(m).standard_normal((m, Q_IN)).astype(
        np.float32)
    want = np.asarray(jdp.fused_quant_matmul(jnp.asarray(x), j))
    got = tfm.fused_quant_matmul(torch.from_numpy(x), t).numpy()
    assert_close(got, want, "float32")


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, t = _tensors("u3", seed=40)
    _, p = _tensors("pb", seed=41)
    x = torch.zeros(8, 8 * t.group_cols)
    with pytest.raises(ValueError):        # width != 8*Gp
        trm.rowpair_u3_matmul(torch.zeros(8, 64), t.planes)
    with pytest.raises(TypeError):         # dtype
        trm.rowpair_u3_matmul(x.half(), t.planes)
    with pytest.raises(ValueError):        # pb planes on the u3 kernel
        trm.rowpair_u3_matmul(torch.zeros(8, 8 * p.group_cols), p.planes)
    with pytest.raises(ValueError):        # rows past x
        trm.rowpair_u3_matmul(x, t.planes, rows=9)
    with pytest.raises(ValueError):        # scale of the wrong length
        trm.rowpair_u3_matmul(x, t.planes, scale_vec=torch.ones(Q_OUT + 2))
    with pytest.raises(RuntimeError):      # no kernel for this device
        trm.rowpair_pb_matmul(
            torch.zeros(8, 8 * p.group_cols, device="meta"),
            {k: v.to("meta") for k, v in p.planes.items()}, RS)


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    _, t = _tensors("u3", seed=50)
    _, p = _tensors("pb", seed=51)
    before = (trm.rowpair_u3_matmul.launches, trm.rowpair_pb_matmul.launches)
    x = torch.randn(8, 8 * t.group_cols)
    assert torch.equal(trm.rowpair_u3_matmul(x, t.planes, rows=3),
                       trm.rowpair_matmul_ref(x, "u3", t.planes, rows=3))
    xp = torch.randn(8, 8 * p.group_cols)
    assert torch.equal(trm.rowpair_pb_matmul(xp, p.planes, RS),
                       trm.rowpair_matmul_ref(xp, "pb", p.planes, RS))
    assert (trm.rowpair_u3_matmul.launches,
            trm.rowpair_pb_matmul.launches) == before
