"""The port's QuantLinear / FusedQuantLinear against the JAX package's
``apply`` / ``fused_apply`` on carried-across params, the port's loader on
the golden reference-schema fixture, and its safetensors reader.

Tolerances: with compute_dtype=float32 every quantized product is exact and
only f32 sum order differs (1e-5 of the output's max). With the default
bf16 compute dtype both packages round each kernel output to bf16, and the
sum order can land on the neighbouring bf16 value (one bf16 ulp, 2^-8
relative), hence 1e-2 of the max.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.nn import qlinear as JQL
from quip_for_all_tpu.transforms.incoherence import get_hadK as jget_hadK
from quip_for_all_tpu.utils.random_quantized import random_qlinear

from quip_for_all_tpu_torch.nn import qlinear as TQL
from quip_for_all_tpu_torch.utils.checkpoint import load_quantized
from quip_for_all_tpu_torch.utils.convert import qlinear_from_jax
from quip_for_all_tpu_torch.utils.safetensors_io import load_file

pytestmark = pytest.mark.fast

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CODEBOOKS = ["e8p12", "d4", "hi", "e8p12rvq3b", "e8p12rvq4b"]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _jlin(in_f, out_f, seed, per_channel=False, bias=False, lspec=None,
          SU=None, rng=None):
    rng = rng or np.random.default_rng(seed)
    p = random_qlinear(jget_codebook("E8P12"), in_f, out_f, rng,
                       dtype=jnp.float32, lspec=lspec, SU=SU)
    if per_channel:
        p = dataclasses.replace(p, per_channel=True, Wscale=jnp.asarray(
            rng.uniform(0.5, 1.5, p.q_out).astype(np.float32)))
    if bias:
        p = dataclasses.replace(p, bias=jnp.asarray(
            rng.standard_normal(out_f).astype(np.float32)))
    return p


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,per_channel,bias", [
    ((384, 256), False, False),     # left hadK K=3, right pure pow2
    ((256, 384), True, True),       # right hadK K=3, per-channel, bias
    ((128, 64), False, False),      # q_out 64: the dense (dequant) route
])
@pytest.mark.parametrize("m", [3, 40])
def test_quant_linear_matches_jax_apply(shape, per_channel, bias, dtype, m):
    in_f, out_f = shape
    jp = _jlin(in_f, out_f, seed=in_f + m, per_channel=per_channel,
               bias=bias)
    tp = qlinear_from_jax(jp, device="cpu")
    x = np.random.default_rng(m).standard_normal((m, in_f)).astype(
        np.float32)
    want = JQL.apply(jp, jnp.asarray(x),
                     compute_dtype=getattr(jnp, dtype))
    got = tp(torch.from_numpy(x), compute_dtype=getattr(torch, dtype))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("outs", [(128, 64, 64), (384, 384)])
@pytest.mark.parametrize("m", [1, 40])
def test_fused_quant_linear_matches_jax_fused_apply(outs, m):
    """(128, 64, 64): qkv with GQA widths, per-segment epilogue;
    (384, 384): gate/up, the uniform batched epilogue with hadK stacks."""
    rng = np.random.default_rng(sum(outs) + m)
    D = 128
    lspec = jget_hadK(D, use_rand=True, rng=rng)
    su = np.sign(rng.standard_normal(D)).astype(np.float32)
    jps = [_jlin(D, o, 0, lspec=lspec, SU=su, rng=rng) for o in outs]
    jf = JQL.fuse_qlinears(jps)
    tf = TQL.fuse_qlinears([qlinear_from_jax(p, "cpu") for p in jps])
    assert tf.right_uniform == jf.right_uniform == (len(set(outs)) == 1)
    x = rng.standard_normal((m, D)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        want = JQL.fused_apply(jf, jnp.asarray(x),
                               compute_dtype=getattr(jnp, dtype))
        got = tf(torch.from_numpy(x), compute_dtype=getattr(torch, dtype))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, TOL[dtype])


@pytest.mark.parametrize("impl", ["dequant", "plain"])
def test_routes_agree(impl):
    """The dense route and the forced plain twin agree with the default
    (auto -> fused) route at f32 compute."""
    jp = _jlin(384, 256, seed=5)
    tp = qlinear_from_jax(jp, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 384)).astype(np.float32))
    base = tp(x, compute_dtype=torch.float32)
    other = tp(x, compute_dtype=torch.float32, matmul_impl=impl)
    torch.testing.assert_close(other, base, rtol=1e-5, atol=1e-5)


def test_load_quantized_golden_reproduces_expected():
    """As tests/test_golden_reference.py does for the JAX loader: the full
    linear maps of q_proj (128->128) and down_proj (256->128), rel < 2e-4,
    through the port's own reader and loader."""
    cfg, model, qcfg = load_quantized(os.path.join(GOLDEN, "e8p12"),
                                      device="cpu")
    exp = np.load(os.path.join(GOLDEN, "e8p12", "expected.npz"))
    blk = model.layers[0]
    for role, lin in (("q_proj", blk["self_attn"]["q_proj"]),
                      ("down_proj", blk["mlp"]["down_proj"])):
        n = lin.in_features
        got = lin(torch.eye(n), compute_dtype=torch.float32).numpy()
        want = exp[role]
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 2e-4, (role, rel)


@pytest.mark.parametrize("cb", CODEBOOKS)
def test_safetensors_reader_equals_safetensors_numpy(cb):
    from safetensors.numpy import load_file as ref_load
    path = os.path.join(GOLDEN, cb, "model.safetensors")
    ours, theirs = load_file(path), ref_load(path)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert np.array_equal(ours[k], v), k


def test_safetensors_reader_widens_bf16_exactly(tmp_path):
    import ml_dtypes
    from safetensors.numpy import save_file
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    save_file({"a": a, "b": np.arange(4, dtype=np.int32)},
              str(tmp_path / "t.safetensors"))
    got = load_file(str(tmp_path / "t.safetensors"))
    assert got["a"].dtype == np.float32
    assert np.array_equal(got["a"], a.astype(np.float32))
    assert np.array_equal(got["b"], np.arange(4, dtype=np.int32))


def test_unported_checkpoints_raise(tmp_path):
    """Every codebook loads now (tests/test_torch_codebooks.py); a
    tensor-parallel checkpoint still raises, naming its roadmap slice."""
    import json
    import shutil
    d = tmp_path / "d4_tp"
    shutil.copytree(os.path.join(GOLDEN, "d4"), d)
    with open(d / "config.json") as f:
        cfg = json.load(f)
    qcfg = cfg.get("quantization_config")
    if qcfg is None:
        with open(d / "quantization_config.json") as f:
            qcfg = json.load(f)
    qcfg["tp_shards"] = 2
    if "quantization_config" in cfg:
        cfg["quantization_config"] = qcfg
        with open(d / "config.json", "w") as f:
            json.dump(cfg, f)
    else:
        with open(d / "quantization_config.json", "w") as f:
            json.dump(qcfg, f)
    with pytest.raises(NotImplementedError, match="slice 8"):
        load_quantized(str(d), device="cpu")
