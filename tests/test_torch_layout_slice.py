"""The remaining runtime layouts end to end on the CPU: E8P12 in bfp, sw2
and sw4, E8P12RVQ4B in paired, and E8P12 nibble with split-K.

- The golden reference-schema fixtures load through ``load_quantized``
  with ``layout=`` and hold ``expected.npz`` to rel < 2e-4 in f32, as
  tests/test_golden_reference.py holds the JAX loader.
- ``fuse_qlinears`` over bfp / sw4 / paired segments gives the JAX
  package's planes and outputs.
- A tiny JAX random llama built under QFA_BFP=1, QFA_SPLIT_DECODE=2 / 4 or
  QFA_RVQ_PAIRED=1 (the JAX package's build-time switches), and one with
  nibble planes run under QFA_KSPLIT=2 (its call-time switch; the port's
  is ``set_ksplit``), carried across with ``from_jax_params``, generates
  the JAX greedy ids through the port, with logits within
  test_torch_slice.py's 2e-2 of the max (both packages round every
  quantized linear's output to bf16). The split-K model is 2048 wide, the
  least width whose 256 padded groups split.
- ``stack_qlinears`` re-lays a tiny Mixtral's bfp / sw2 / paired experts
  to the JAX package's nibble planes, and the port generates like JAX.
- The port's own random models in these layouts hold valid E8P12 codes
  and run on the CPU through the plain twins, counting no launch.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import qlinear as JQL
from quip_for_all_tpu.runtime.generate import generate as jgenerate
from quip_for_all_tpu.transforms.incoherence import get_hadK as jget_hadK
from quip_for_all_tpu.utils import random_quantized as JR

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.nn import qlinear as TQL
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops import layout_matmul, rowpair_matmul
from quip_for_all_tpu_torch.ops import qtensor as tqt
from quip_for_all_tpu_torch.utils.convert import (from_jax_params,
                                                  qlinear_from_jax)

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models, so that a parallel test run
    does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
WIDE = dict(vocab_size=256, hidden_size=2048, intermediate_size=2048,
            num_hidden_layers=1, num_attention_heads=16,
            num_key_value_heads=16, max_position_embeddings=128)
SWITCHES = ("QFA_E8P_U3", "QFA_RVQ_PB", "QFA_RVQ_PAIRED", "QFA_BFP",
            "QFA_SPLIT_DECODE", "QFA_KSPLIT")
# case: (dims, codebook, layout, JAX switches, the port's split-K request)
CASES = {"bfp": (DIMS, "E8P12", "bfp", {"QFA_BFP": "1"}, 0),
         "sw2": (DIMS, "E8P12", "sw2", {"QFA_SPLIT_DECODE": "2"}, 0),
         "sw4": (DIMS, "E8P12RVQ4B", "sw4", {"QFA_SPLIT_DECODE": "4"}, 0),
         "paired": (DIMS, "E8P12RVQ4B", "paired", {"QFA_RVQ_PAIRED": "1"},
                    0),
         "ksplit": (WIDE, "E8P12", "nibble", {"QFA_KSPLIT": "2"}, 2)}


@contextlib.contextmanager
def _jax_env(env):
    """The JAX package's layout and split-K switches, set only while it
    builds or runs."""
    with pytest.MonkeyPatch.context() as mp:
        for k in SWITCHES:
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        yield


@pytest.mark.parametrize("fixture,layout", [
    ("e8p12", "bfp"), ("e8p12", "sw2"), ("e8p12", "sw4"),
    ("e8p12rvq4b", "paired"), ("e8p12rvq4b", "bfp")])
def test_golden_fixture_through_the_layout(fixture, layout):
    path = os.path.join(GOLDEN, fixture)
    cfg, model, qcfg = qt.load_quantized(path, device="cpu", layout=layout)
    exp = np.load(os.path.join(path, "expected.npz"))
    blk = model.layers[0]
    for role, lin in (("q_proj", blk["self_attn"]["q_proj"]),
                      ("down_proj", blk["mlp"]["down_proj"])):
        assert lin.qweight.layout == layout
        got = lin(torch.eye(lin.in_features),
                  compute_dtype=torch.float32).numpy()
        rel = np.abs(got - exp[role]).max() / (np.abs(exp[role]).max()
                                               + 1e-9)
        assert rel < 2e-4, (fixture, layout, role, rel)


@pytest.mark.parametrize("case", ["bfp", "sw4", "paired"])
def test_fuse_qlinears_matches_jax(case):
    _, cb, layout, env, _ = CASES[case]
    rng = np.random.default_rng(11)
    with _jax_env(env):
        spec = jget_hadK(512, use_rand=True, rng=rng)
        SU = np.sign(rng.standard_normal(512)).astype(np.float32)
        ps = [JR.random_qlinear(jget_codebook(cb), 512, n, rng, lspec=spec,
                                SU=SU, dtype=jnp.float32)
              for n in (256, 128, 128)]
    ps = [dataclasses.replace(p, SU=ps[0].SU, had_left=ps[0].had_left)
          for p in ps]
    assert ps[0].qweight.layout == layout
    jf = JQL.fuse_qlinears(ps)
    port = [qlinear_from_jax(p, "cpu") for p in ps]
    for p in port[1:]:              # shared left side, as the model fuses
        p.SU, p.had_left = port[0].SU, port[0].had_left
    tf = TQL.fuse_qlinears(port)
    assert tf.qweight.layout == layout
    for k, v in jf.qweight.planes.items():
        assert np.array_equal(tf.qweight.planes[k].numpy(), np.asarray(v)), k
    x = np.random.default_rng(12).standard_normal((3, 512)).astype(
        np.float32)
    with _jax_env(env):
        want = JQL.fused_apply(jf, jnp.asarray(x), compute_dtype=jnp.float32)
    got = tf(torch.from_numpy(x), compute_dtype=torch.float32)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.fixture(scope="module", params=sorted(CASES))
def models(request):
    dims, cb, layout, env, ksplit = CASES[request.param]
    jcfg = JConfig(**dims)
    with _jax_env(env):
        params = JR.random_quantized_model(jcfg, cb, seed=0,
                                           dtype=jnp.float32,
                                           quantize_head=True)
    tcfg = qt.ModelConfig(**dims)
    port = qt.set_ksplit(
        TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu")), ksplit)
    return (layout, env, ksplit, jcfg, JM.fuse_for_inference(jcfg, params),
            tcfg, port)


def _japply(cfg, params, ids, **kw):
    """JAX's ``model_apply`` logits as one jitted forward: a few seconds
    of compile, where the eager forward compiles the interpret-mode
    kernels op by op (~4x longer on these models)."""
    fwd = jax.jit(lambda p, i: JM.model_apply(cfg, p, i, **kw)[0])
    return fwd(params, jnp.asarray(ids))


def _logits_close(jcfg, jparams, ids, S, logits):
    """The JAX side's per-step logits from one causal forward over the
    generated ids (a decode step's logits are its prefix's last ones)."""
    jl = _japply(jcfg, jparams, ids[:, :-1], dtype=jnp.float32)
    jl = np.asarray(jl)[0, S - 1:]
    tl = torch.stack(logits, dim=1)[0].numpy()
    assert tl.shape == jl.shape and np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


def test_generate_matches_jax(models, monkeypatch):
    """A 12-token prompt (padded m 16, split-K where asked) and 4 greedy
    tokens (m = 1). The split-K case counts its K6 twin calls: every linear
    of every step (qkv, o, gate/up, down and head, all 256 groups)."""
    layout, env, ksplit, jcfg, jparams, tcfg, port = models
    assert port.lm_head.qweight.layout == layout
    assert port.layers[0]["mlp"]["gateup_proj"].qweight.layout == layout
    S, new = 12, 4
    prompt = np.random.default_rng(S).integers(0, 256, (1, S))
    with _jax_env(env):
        want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt), new,
                                    cache_len=64, dtype_str="float32"))
    calls = []
    spy = tfm.ksplit_decode_matmul

    def counting(*a, **k):
        calls.append(1)
        return spy(*a, **k)
    monkeypatch.setattr(tfm, "ksplit_decode_matmul", counting)
    got, logits = qt.generate(tcfg, port, torch.from_numpy(prompt), new,
                              cache_len=64, dtype=torch.float32,
                              device="cpu", return_logits=True)
    assert np.array_equal(got.numpy(), want)
    assert len(calls) == (5 * new if ksplit else 0)
    with _jax_env(env):
        _logits_close(jcfg, jparams, want, S, logits)


@pytest.mark.parametrize("codebook,layout,env", [
    ("E8P12", "bfp", {"QFA_BFP": "1"}),
    ("E8P12", "sw2", {"QFA_SPLIT_DECODE": "2"}),
    ("E8P12RVQ4B", "paired", {"QFA_RVQ_PAIRED": "1"})])
def test_mixtral_experts_relay_to_nibble_as_jax(codebook, layout, env):
    cfg = dict(DIMS, num_hidden_layers=1, num_local_experts=4,
               num_experts_per_tok=2)
    jcfg = JConfig(arch="mixtral", **cfg)
    with _jax_env(env):
        params = JR.random_quantized_model(jcfg, codebook, seed=0,
                                           dtype=jnp.float32)
        jfused = JM.fuse_for_inference(jcfg, params)
    assert params["layers"][0]["block_sparse_moe"]["experts"][0][
        "w1"].qweight.layout == layout
    tcfg = qt.ModelConfig(arch="mixtral", **cfg)
    port = qt.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    jst = jfused["layers"][0]["block_sparse_moe"]["experts_stacked"]
    tst = port.layers[0]["block_sparse_moe"]["experts_stacked"]
    for name in ("w13", "w2"):
        assert sorted(tst[name].planes) == sorted(jst[name].planes)
        for k, v in jst[name].planes.items():
            assert np.array_equal(tst[name].planes[k].numpy(),
                                  np.asarray(v)), (name, k)
    prompt = np.random.default_rng(3).integers(0, 256, (1, 12))
    with _jax_env(env):
        want = np.asarray(jgenerate(jcfg, jfused, jnp.asarray(prompt), 3,
                                    cache_len=64, dtype_str="float32"))
    got = qt.generate(tcfg, port, torch.from_numpy(prompt), 3, cache_len=64,
                      dtype=torch.float32, device="cpu")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("codebook,layout", [
    ("E8P12", "bfp"), ("E8P12", "sw2"), ("E8P12", "sw4"),
    ("E8P12RVQ4B", "bfp"), ("E8P12RVQ4B", "paired")])
def test_port_random_model_holds_valid_codes(codebook, layout):
    cfg = qt.ModelConfig(**{**DIMS, "num_hidden_layers": 1})
    model = qt.random_quantized_model(cfg, codebook, seed=1, device="cpu",
                                      quantize_head=True, layout=layout)
    lins = [model.lm_head] + [
        m for blk in model.layers for part in ("self_attn", "mlp")
        for m in blk[part].values()]
    for lin in lins:
        q = lin.qweight
        assert q.layout == layout and q.codebook_id == codebook
        if layout == "paired":
            u0, _, u1, _ = tqt.paired_uv_from_planes(q.planes)
            G = q.q_in // 8
            assert max(int(u0[:, :G].max()), int(u1[:, :G].max())) <= 5
        tqt.to_raw_idxs(q)                  # every group a real codeword
    fused = qt.fuse_for_inference(cfg, model)
    counters = (layout_matmul.bfp_decode_matmul,
                layout_matmul.sw_decode_matmul,
                layout_matmul.ksplit_decode_matmul,
                rowpair_matmul.paired_decode_matmul,
                tfm.fused_decode_matmul)
    before = [c.launches for c in counters]
    prompt = torch.arange(12)[None]
    a = qt.generate(cfg, fused, prompt, 3, cache_len=32, dtype=torch.float32,
                    device="cpu")
    b = qt.generate(cfg, fused, prompt, 3, cache_len=32, dtype=torch.float32,
                    device="cpu", linear_kw={"matmul_impl": "plain"})
    assert torch.equal(a, b) and a.shape == (1, 15)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("layout", ["paired", "sw4"])
def test_port_random_mixtral_stacks_the_new_layouts(layout):
    cfg = qt.ModelConfig(arch="mixtral", **dict(
        DIMS, num_hidden_layers=1, num_local_experts=4,
        num_experts_per_tok=2))
    model = qt.random_quantized_model(cfg, "E8P12RVQ4B", seed=2,
                                      device="cpu", layout=layout)
    blk = model.layers[0]
    assert blk["self_attn"]["q_proj"].qweight.layout == layout
    st = blk["block_sparse_moe"]["experts_stacked"]
    assert sorted(st["w13"].planes) == ["w0", "w1"]     # nibble, 2 sets
    assert st["w13"].planes["w0"].dtype == torch.int32
    out = qt.generate(cfg, qt.fuse_for_inference(cfg, model),
                      torch.arange(6)[None], 2, cache_len=16,
                      dtype=torch.float32, device="cpu")
    assert out.shape == (1, 8)
