"""The port's fused decode+matmul (ops/fused_matmul.py) against the JAX
package's Pallas kernel, run in interpret mode as the JAX tests run it.

On the CPU the wrapper takes the plain twin; on a card the kernel is held
against the same twin in tests/test_torch_kernel_cuda.py.

Tolerances: every product is exact in f32 (nibbles 0..15 times f32- or
bf16-valued x), so f32 outputs differ only by summation order
(max|Δ| <= 1e-5 * max|ref|); a bf16 output may differ by that f32
allowance plus one bf16 ulp of the element (two f32 sums on either side
of a rounding boundary land on neighbouring bf16 values; near zero the f32
allowance dominates).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops.qtensor import QuantizedTensor as JQT

from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor as TQT

pytestmark = pytest.mark.fast

Q_OUT, Q_IN = 128, 384          # G = 48 < Gp = 128: pad lanes exercised
RS = 1 / 3.45                   # E8P12RVQ4B default residual scale


def _case(m, n_sets, with_scale, seed):
    rng = np.random.default_rng(seed)
    Gp = 128
    planes = {f"w{i}": rng.integers(0, 1 << 32, (Q_OUT, Gp), dtype=np.uint64)
              .astype(np.uint32).view(np.int32) for i in range(n_sets)}
    cb = "E8P12" if n_sets == 1 else "E8P12RVQ4B"
    ors = -1.0 if n_sets == 1 else RS
    # x in the grouped layout, zero on the pad lanes g >= G (as the
    # prologue emits it)
    x = rng.standard_normal((m, 8, Gp)).astype(np.float32)
    x[:, :, Q_IN // 8:] = 0.0
    x = x.reshape(m, 8 * Gp)
    scale = (rng.uniform(0.5, 1.5, Q_OUT).astype(np.float32)
             if with_scale else None)
    return planes, cb, ors, x, scale


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got: np.ndarray, want: np.ndarray, dtype: str):
    f32_tol = 1e-5 * np.abs(want).max()
    if dtype == "float32":
        err = np.abs(got - want).max()
        assert err <= f32_tol, err
    else:
        ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp + f32_tol), \
            np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 40])
def test_plain_twin_matches_pallas(m, n_sets, with_scale, dtype):
    planes, cb, ors, x, scale = _case(m, n_sets, with_scale, seed=m * 7
                                      + n_sets)
    jqt = JQT({k: jnp.asarray(v) for k, v in planes.items()}, cb, Q_OUT,
              Q_IN, ors)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jdp.fused_quant_matmul_pre(
        jnp.asarray(x).astype(jdt), jqt,
        scale_vec=None if scale is None else jnp.asarray(scale))
    want = np.asarray(want.astype(jnp.float32))

    tqt = TQT({k: torch.from_numpy(v) for k, v in planes.items()}, cb,
              Q_OUT, Q_IN, ors)
    tdt = getattr(torch, dtype)
    got = tfm.fused_quant_matmul_pre(
        torch.from_numpy(x).to(tdt), tqt,
        scale_vec=None if scale is None else torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (m, Q_OUT)
    assert_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("m", [1, 40])
def test_natural_order_entry_matches_pallas(m):
    """fused_quant_matmul permutes natural-order x itself."""
    rng = np.random.default_rng(m)
    w = (rng.integers(0, 1 << 32, (Q_OUT, 128), dtype=np.uint64)
         .astype(np.uint32).view(np.int32))
    x = rng.standard_normal((m, Q_IN)).astype(np.float32)
    want = np.asarray(jdp.fused_quant_matmul(
        jnp.asarray(x), JQT({"w0": jnp.asarray(w)}, "E8P12", Q_OUT, Q_IN)))
    got = tfm.fused_quant_matmul(
        torch.from_numpy(x), TQT({"w0": torch.from_numpy(w)}, "E8P12",
                                 Q_OUT, Q_IN))
    assert_close(got.numpy(), want, "float32")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((128, 128), dtype=torch.int32)
    aff = ((0.5, -2.75),)
    with pytest.raises(ValueError):        # width != 8*Gp
        tfm.fused_decode_matmul(torch.zeros(8, 512), [w], aff)
    with pytest.raises(TypeError):         # dtype
        tfm.fused_decode_matmul(torch.zeros(8, 1024, dtype=torch.float16),
                                [w], aff)
    with pytest.raises(ValueError):        # three plane sets
        tfm.fused_decode_matmul(torch.zeros(8, 1024), [w, w, w], aff * 3)
    with pytest.raises(ValueError):        # non-contiguous x
        tfm.fused_decode_matmul(torch.zeros(1024, 8).T, [w], aff)
    with pytest.raises(RuntimeError):      # no kernel for this device
        tfm.fused_decode_matmul(torch.zeros(8, 1024, device="meta"),
                                [w.to("meta")], aff)


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    before = tfm.fused_decode_matmul.launches
    w = torch.zeros((128, 128), dtype=torch.int32)
    out = tfm.fused_decode_matmul(torch.ones(8, 1024), [w], ((0.5, -2.75),))
    assert torch.equal(out, torch.full((8, 128), -2.75 * 1024))
    assert tfm.fused_decode_matmul.launches == before
