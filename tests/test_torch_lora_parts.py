"""The training pieces under the LoRA slice: ``calc_weight`` and the
training forward of ``nn/qlinear.py`` (``training=True``, a
``dense_weight``, a ``W_cache``) against the JAX package's, SU/SV
gradients included; and autograd through the incoherence transforms
(``gradcheck`` in float64, its fast mode: one random projection of the
Jacobian, which for these linear maps is as strict as the full one at a
fraction of its backward calls; every product a dense einsum).

Tolerance: within 1e-5 of each tensor's max (f32; the transforms sum in
other orders).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import qlinear as jql
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.nn import qlinear as tql
from quip_for_all_tpu_torch.transforms import incoherence as tinc
from quip_for_all_tpu_torch.utils.convert import qlinear_from_jax

pytestmark = pytest.mark.fast

DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=128)


@pytest.fixture(scope="module")
def jlayer():
    return random_quantized_model(JConfig(**DIMS), "E8P12", seed=0,
                                  dtype=jnp.float32)["layers"][0]


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def _layer(jlayer, name, per_channel):
    """q_proj (128 -> 128, power-of-2 transforms) or down_proj (384 -> 128,
    a 3x3 hadK on the left), optionally with a per-channel scale."""
    p = (jlayer["self_attn"]["q_proj"] if name == "q" else
         jlayer["mlp"]["down_proj"])
    if per_channel:
        w = np.random.default_rng(1).uniform(0.5, 1.5, p.q_out)
        p = dataclasses.replace(p, per_channel=True,
                                Wscale=jnp.asarray(w / w.mean(), jnp.float32))
    return p


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("name", ["q", "down"])
def test_calc_weight_matches_jax(jlayer, name, per_channel):
    p = _layer(jlayer, name, per_channel)
    t = qlinear_from_jax(p, "cpu")
    W = tql.calc_weight(t)
    assert W.shape == (p.q_in, p.q_out) and W.dtype == torch.float32
    _close(W.numpy(), jql.calc_weight(p))


@pytest.mark.parametrize("mode", ["training", "dense_weight", "W_cache"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("name", ["q", "down"])
def test_training_forward_and_su_sv_grads_match_jax(jlayer, name,
                                                    per_channel, mode):
    """out and d(sum(out * probe)) / d(SU, SV) through the dense W."""
    p = _layer(jlayer, name, per_channel)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, p.in_features)).astype(np.float32)
    probe = rng.standard_normal((2, 5, p.out_features)).astype(np.float32)

    def jloss(su, sv):
        q = dataclasses.replace(p, SU=su, SV=sv)
        out = jql.apply(q, jnp.asarray(x), training=True)
        return jnp.sum(out * probe), out
    (_, jout), (jsu, jsv) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(p.SU, p.SV)

    t = qlinear_from_jax(p, "cpu")
    t.SU.requires_grad_(True)
    t.SV.requires_grad_(True)
    kw = {"training": True}
    if mode == "dense_weight":
        kw = {"dense_weight": tql.calc_weight(t)}
    elif mode == "W_cache":
        t.W_cache = tql.calc_weight(t)
        kw = {"training": True}
    out = t(torch.from_numpy(x), **kw)
    (out * torch.from_numpy(probe)).sum().backward()
    _close(out.detach().numpy(), jout)
    _close(t.SU.grad.numpy(), jsu)
    _close(t.SV.grad.numpy(), jsv)
    # the eval forward computes the same function
    with torch.no_grad():
        ev = t(torch.from_numpy(x), compute_dtype=torch.float32)
    _close(ev.numpy(), jout)


def _spec(n, K):
    g = torch.Generator().manual_seed(n + K)
    hadK = (None if K == 1 else
            tinc.random_orthogonal(K, g).to(torch.float64))
    return tinc.HadSpec(hadK, K, n)


@pytest.mark.parametrize("n,K", [(64, 1), (96, 3), (256, 1)])
def test_transforms_are_differentiable(n, K):
    spec = _spec(n, K)
    X = torch.randn(3, n, dtype=torch.float64, requires_grad=True)
    for fn in (lambda X: tinc.matmul_hadU(X, spec, scale=0.7),
               lambda X: tinc.matmul_hadUt(X, spec),
               lambda X: tinc.hadamard_transform(X[:, :64], 0.5)):
        assert torch.autograd.gradcheck(fn, (X,), fast_mode=True)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("n,K,Gp", [(128, 1, 128), (384, 3, 128),
                                    (1024, 1, 256)])
def test_grouped_prologue_is_differentiable(n, K, Gp, split):
    """matmul_hadUt_grouped: gradcheck, and its gradient is the adjoint
    (U applied to the cotangent taken back to natural order)."""
    spec = _spec(n, K)
    X = torch.randn(2, n, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda X: tinc.matmul_hadUt_grouped(X, spec, Gp, scale=1.5,
                                            split=split), (X,),
        fast_mode=True)
    G = torch.randn(2, 8 * Gp, dtype=torch.float64)
    Y = tinc.matmul_hadUt_grouped(X, spec, Gp, scale=1.5, split=split)
    (gx,) = torch.autograd.grad((Y * G).sum(), X)
    # grouped lane q*(P*Gp) + P*g + j <- natural 8g + (8/P)*j + q
    nat = (G.reshape(2, 8 // split, Gp, split)[:, :, : n // 8]
           .permute(0, 2, 3, 1).reshape(2, n))
    want = tinc.matmul_hadU(nat, spec, scale=1.5)
    assert torch.allclose(gx, want, atol=1e-10)
