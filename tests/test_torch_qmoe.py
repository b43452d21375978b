"""Stacked-expert MoE (nn/qmoe.py) and the Mixtral block (models/llama.py
``moe_apply``) against the JAX package, on a tiny Mixtral whose JAX random
weights are carried across with ``from_jax_params``.

The JAX side runs its Pallas MoE kernel in interpret mode (conftest). All
comparisons run in float32 compute: products are exact in both packages,
so outputs differ by summation order and by the transforms' einsum order,
which stay within 1e-4 * max|ref|. The bf16 case allows 2e-2 * max|ref|:
a sum-order difference can move a bf16 kernel output to its neighbour,
which the right transform then spreads.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import qlinear as jql
from quip_for_all_tpu.nn import qmoe as jqmoe
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import qmoe as tqmoe
from quip_for_all_tpu_torch.nn.qlinear import apply as tapply
from quip_for_all_tpu_torch.utils.convert import from_jax_params

pytestmark = pytest.mark.fast

DIMS = dict(arch="mixtral", vocab_size=256, hidden_size=128,
            intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_local_experts=4,
            num_experts_per_tok=2)
D, I, E = 128, 384, 4


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = from_jax_params(params, "cpu")
    return (jcfg, params, JM.fuse_for_inference(jcfg, params), tcfg, port,
            TM.fuse_for_inference(tcfg, port))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _near(got, want, tol=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_stack_experts_matches_jax(models):
    _, jparams, _, _, port, _ = models
    for jb, tb in zip(jparams["layers"], port.layers):
        js = jqmoe.stack_experts(jb["block_sparse_moe"])
        ts = tqmoe.stack_experts(tb["block_sparse_moe"])
        assert js is not None and ts is not None
        for key in ("w13", "w2"):
            j, t = js[key], ts[key]
            assert (t.E, t.nseg, t.in_features, t.q_in, t.seg_out, t.K_left,
                    t.K_right, t.codebook_id) == (
                j.E, j.nseg, j.in_features, j.q_in, j.seg_out, j.K_left,
                j.K_right, j.codebook_id)
            assert t.plane_keys == sorted(j.planes)
            for k in t.plane_keys:
                assert np.array_equal(t.planes[k].numpy(),
                                      np.asarray(j.planes[k]))
            for name in ("SU", "had_left", "pre_vec", "had_right", "SV_all",
                         "bias_all"):
                a, b = getattr(t, name), getattr(j, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    assert np.array_equal(_np(a), _np(b)), name


def test_unstackable_experts_stay_per_expert(models):
    """An expert whose w1 and w3 do not share their left side keeps the
    per-expert list, in both packages."""
    _, jparams, _, _, port, _ = models
    moe = port.layers[0]["block_sparse_moe"]
    w3 = moe["experts"][1]["w3"]
    su = w3.SU
    w3.SU = -su
    try:
        assert tqmoe.stack_experts(moe) is None
    finally:
        w3.SU = su
    assert tqmoe.stack_experts(moe) is not None


@pytest.mark.parametrize("e", range(E))
def test_unstack_qlinear_matches_jax(models, e):
    _, _, jfused, _, _, tfused = models
    jst = jfused["layers"][1]["block_sparse_moe"]["experts_stacked"]
    tst = tfused.layers[1]["block_sparse_moe"]["experts_stacked"]
    x = np.random.default_rng(e).standard_normal((3, I)).astype(np.float32)
    for key, xin in (("w13", x[:, :D]), ("w2", x)):
        for jseg, tseg in zip(jqmoe.unstack_qlinear(jst[key], e),
                              tqmoe.unstack_qlinear(tst[key], e)):
            want = jql.apply(jseg, jnp.asarray(xin),
                             compute_dtype=jnp.float32)
            got = tapply(tseg, torch.from_numpy(xin),
                         compute_dtype=torch.float32)
            _near(got, want)


@pytest.mark.parametrize("key", ["w13", "w2"])
@pytest.mark.parametrize("R", [1, 2, 5, 24])
def test_stacked_rows_apply_matches_jax(models, key, R):
    _, _, jfused, _, _, tfused = models
    jst = jfused["layers"][0]["block_sparse_moe"]["experts_stacked"][key]
    tst = tfused.layers[0]["block_sparse_moe"]["experts_stacked"][key]
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, jst.in_features)).astype(np.float32)
    eids = rng.integers(0, E, R).astype(np.int32)
    want = jqmoe.stacked_rows_apply(jst, jnp.asarray(x), jnp.asarray(eids),
                                    compute_dtype=jnp.float32)
    got = tqmoe.stacked_rows_apply(tst, torch.from_numpy(x),
                                   torch.from_numpy(eids), rows_per_expert=R,
                                   compute_dtype=torch.float32)
    _near(got, want)


def test_stacked_rows_apply_bf16_compute_matches_jax(models):
    _, _, jfused, _, _, tfused = models
    jst = jfused["layers"][0]["block_sparse_moe"]["experts_stacked"]["w13"]
    tst = tfused.layers[0]["block_sparse_moe"]["experts_stacked"]["w13"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, D)).astype(np.float32)
    eids = rng.integers(0, E, 6).astype(np.int32)
    want = jqmoe.stacked_rows_apply(jst, jnp.asarray(x), jnp.asarray(eids))
    got = tqmoe.stacked_rows_apply(tst, torch.from_numpy(x),
                                   torch.from_numpy(eids), rows_per_expert=6)
    _near(got, want, tol=2e-2)


@pytest.mark.parametrize("S", [1, 12])
def test_moe_sparse_apply_matches_jax(models, S):
    jcfg, _, jfused, tcfg, _, tfused = models
    rng = np.random.default_rng(S)
    x = rng.standard_normal((1, S, D)).astype(np.float32)
    logits = rng.standard_normal((1, S, E)).astype(np.float32)
    want = jqmoe.moe_sparse_apply(
        jcfg, jfused["layers"][0]["block_sparse_moe"], jnp.asarray(x),
        jnp.asarray(logits), compute_dtype=jnp.float32)
    got = tqmoe.moe_sparse_apply(
        tcfg, tfused.layers[0]["block_sparse_moe"], torch.from_numpy(x),
        torch.from_numpy(logits), compute_dtype=torch.float32)
    _near(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,S", [(1, 12), (1, 40), (2, 16)])
def test_moe_apply_matches_jax(models, fused, B, S):
    """Both formulations of the block: the sparse route below 32 tokens and
    the dense masked loop over unstacked views from 32 on (fused), and the
    per-expert loop of an unfused model."""
    jcfg, jparams, jfused, tcfg, port, tfused = models
    jp = (jfused if fused else jparams)["layers"][1]["block_sparse_moe"]
    tp = (tfused if fused else port).layers[1]["block_sparse_moe"]
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, D)).astype(np.float32)
    want = JM.moe_apply(jcfg, jp, jnp.asarray(x),
                        {"compute_dtype": jnp.float32}, None)
    got = TM.moe_apply(tcfg, tp, torch.from_numpy(x),
                       {"compute_dtype": torch.float32})
    _near(got, want)


@pytest.mark.parametrize("S,sparse", [(31, True), (32, False)])
def test_route_switches_at_32_tokens(models, monkeypatch, S, sparse):
    _, _, _, tcfg, _, tfused = models
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return tqmoe.moe_sparse_apply(*a, **k)
    monkeypatch.setattr(TM, "moe_sparse_apply", spy)
    x = torch.randn((1, S, D), generator=torch.Generator().manual_seed(S))
    TM.moe_apply(tcfg, tfused.layers[0]["block_sparse_moe"], x, {})
    assert bool(calls) == sparse


def test_plain_impl_reaches_the_stacked_core(models, monkeypatch):
    """``matmul_impl="plain"`` in linear_kw selects the MoE kernel's plain
    twin (chip_smoke.py holds the kernel against it on the card)."""
    from quip_for_all_tpu_torch.ops import moe_matmul
    _, _, _, tcfg, _, tfused = models
    seen = []
    monkeypatch.setattr(tqmoe, "moe_fused_matmul",
                        lambda *a: seen.append("kernel")
                        or moe_matmul.moe_fused_matmul(*a))
    monkeypatch.setattr(tqmoe, "moe_fused_matmul_ref",
                        lambda *a: seen.append("plain")
                        or moe_matmul.moe_fused_matmul_ref(*a))
    x = torch.randn((1, 2, D), generator=torch.Generator().manual_seed(0))
    moe = tfused.layers[0]["block_sparse_moe"]
    a = TM.moe_apply(tcfg, moe, x, {"compute_dtype": torch.float32})
    assert seen == ["kernel", "kernel"]
    seen.clear()
    b = TM.moe_apply(tcfg, moe, x, {"compute_dtype": torch.float32,
                                    "matmul_impl": "plain"})
    assert seen == ["plain", "plain"]
    assert torch.equal(a, b)
