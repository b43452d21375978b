"""The port's incoherence transforms and Hadamard tables against the JAX
package (f32, rtol 1e-5: the same factorisation, sums in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.transforms import hadamard_tables as jht
from quip_for_all_tpu.transforms import incoherence as jinc

from quip_for_all_tpu_torch.transforms import hadamard_tables as tht
from quip_for_all_tpu_torch.transforms import incoherence as tinc

pytestmark = pytest.mark.fast


def _specs(n, use_rand=True):
    rng = np.random.default_rng(n)
    js = jinc.get_hadK(n, use_rand=use_rand, rng=rng)
    ts = tinc.HadSpec(None if js.hadK is None else torch.from_numpy(
        np.asarray(js.hadK, np.float32)), js.K, js.padN)
    return js, ts


def _close(got: torch.Tensor, want, rtol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


@pytest.mark.parametrize("n", [128, 384, 11008])
@pytest.mark.parametrize("transpose", [False, True])
def test_matmul_hadU_matches(n, transpose):
    js, ts = _specs(n)
    assert ts.K == {128: 1, 384: 3, 11008: 43}[n]
    x = np.random.default_rng(1).standard_normal((3, n)).astype(np.float32)
    want = jinc.matmul_hadU(jnp.asarray(x), js, scale=0.7,
                            transpose=transpose)
    got = tinc.matmul_hadU(torch.from_numpy(x), ts, scale=0.7,
                           transpose=transpose)
    _close(got, want)


@pytest.mark.parametrize("n", [128, 384, 11008])
def test_matmul_hadUt_grouped_matches(n):
    js, ts = _specs(n)
    Gp = -(-(n // 8) // 128) * 128
    x = np.random.default_rng(2).standard_normal((5, n)).astype(np.float32)
    want = jinc.matmul_hadUt_grouped(jnp.asarray(x), js, Gp, scale=0.3)
    got = tinc.matmul_hadUt_grouped(torch.from_numpy(x), ts, Gp, scale=0.3)
    _close(got, want)
    # the grouped layout is the plain transform, permuted and zero-padded
    plain = tinc.matmul_hadUt(torch.from_numpy(x), ts, scale=0.3).numpy()
    G = n // 8
    g = got.numpy().reshape(5, 8, Gp)
    assert np.all(g[:, :, G:] == 0)
    np.testing.assert_allclose(g[:, :, :G].transpose(0, 2, 1).reshape(5, n),
                               plain, rtol=1e-5, atol=1e-5)


def test_full_U_is_the_transform():
    js, ts = _specs(384)
    U = tinc.full_U(ts)
    np.testing.assert_allclose(U, jinc.full_U(js), rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(3).standard_normal((2, 384)).astype(np.float32)
    np.testing.assert_allclose(
        tinc.matmul_hadU(torch.from_numpy(x), ts).numpy(), x @ U.T,
        rtol=1e-4, atol=1e-5)


def test_hadamard_tables_bit_equal_for_every_asset_order():
    orders = sorted(jht._asset_tables())
    assert len(orders) == 34
    assert orders == sorted(tht._asset_tables())
    for n in orders:
        a, b = jht.hadamard_matrix(n), tht.hadamard_matrix(n)
        assert a.dtype == b.dtype and np.array_equal(a, b), n


@pytest.mark.parametrize("n", [172 * 64, 20 * 16])
def test_table_factor_specs_equal(n):
    js, ts = jinc.get_hadK(n, use_rand=False), tinc.get_hadK(n,
                                                             use_rand=False)
    assert (js.K, js.padN) == (ts.K, ts.padN)
    assert np.array_equal(np.asarray(js.hadK), np.asarray(ts.hadK))


def test_random_factor_needs_a_generator():
    with pytest.raises(ValueError):
        tinc.get_hadK(384, use_rand=True)
    gen = torch.Generator().manual_seed(0)
    s = tinc.get_hadK(384, use_rand=True, generator=gen)
    q = s.hadK.double()
    assert torch.allclose(q @ q.T, torch.eye(3, dtype=torch.float64),
                          atol=1e-6)
