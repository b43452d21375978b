"""The byte-cut layouts end to end on the CPU: E8P12 in u3, E8P12RVQ4B in
pb and in nibble.

- The golden reference-schema fixtures load through ``load_quantized``
  with ``layout=`` and hold ``expected.npz`` to rel < 2e-4 in f32, as
  tests/test_golden_reference.py holds the JAX loader.
- ``fuse_qlinears`` over u3/pb segments gives the JAX package's planes
  and outputs.
- A tiny JAX random llama (QFA_E8P_U3=1 / QFA_RVQ_PB=1 / unset at build
  time, the JAX package's way to pick the layout) carried across with
  ``from_jax_params`` generates the JAX greedy ids through the port, with
  logits within test_torch_slice.py's 2e-2 of the max (both packages round
  every quantized linear's output to bf16).
- The port's own random u3/pb models hold valid E8P12 codes (u <= 5).
- u3/pb experts do not stack: the port refuses them, where the JAX
  package's ``stack_qlinears`` lets them through into its nibble MoE
  kernel unchanged (ROADMAP.md queue 3).
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
from quip_for_all_tpu_torch.ops import qtensor as tqt
from quip_for_all_tpu_torch.ops import fused_matmul, rowpair_matmul
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
# (codebook, layout, the JAX package's build-time switch)
CASES = {"u3": ("E8P12", "u3", {"QFA_E8P_U3": "1"}),
         "pb": ("E8P12RVQ4B", "pb", {"QFA_RVQ_PB": "1"}),
         "rvq4b_nibble": ("E8P12RVQ4B", "nibble", {})}


@contextlib.contextmanager
def _jax_env(env):
    """The JAX package's layout switches, set only while it builds."""
    with pytest.MonkeyPatch.context() as mp:
        for k in ("QFA_E8P_U3", "QFA_RVQ_PB"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        yield


@pytest.mark.parametrize("fixture,layout", [
    ("e8p12", "u3"), ("e8p12rvq4b", None), ("e8p12rvq4b", "pb")])
def test_golden_fixture_through_the_layout(fixture, layout):
    path = os.path.join(GOLDEN, fixture)
    cfg, model, qcfg = qt.load_quantized(path, device="cpu", layout=layout)
    exp = np.load(os.path.join(path, "expected.npz"))
    blk = model.layers[0]
    for role, lin in (("q_proj", blk["self_attn"]["q_proj"]),
                      ("down_proj", blk["mlp"]["down_proj"])):
        assert lin.qweight.layout == (layout or "nibble")
        if fixture == "e8p12rvq4b":
            assert lin.qweight.opt_resid_scale == qcfg["opt_resid_scale"]
        got = lin(torch.eye(lin.in_features),
                  compute_dtype=torch.float32).numpy()
        rel = np.abs(got - exp[role]).max() / (np.abs(exp[role]).max()
                                               + 1e-9)
        assert rel < 2e-4, (fixture, layout, role, rel)


@pytest.mark.parametrize("case", ["u3", "pb"])
def test_fuse_qlinears_matches_jax(case):
    cb, layout, env = CASES[case]
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
    want = JQL.fused_apply(jf, jnp.asarray(x), compute_dtype=jnp.float32)
    got = tf(torch.from_numpy(x), compute_dtype=torch.float32)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def _japply(cfg, params, ids, **kw):
    """JAX's ``model_apply`` logits as one jitted forward: a few seconds
    of compile, where the eager forward compiles the interpret-mode
    kernels op by op (~4x longer on these models)."""
    fwd = jax.jit(lambda p, i: JM.model_apply(cfg, p, i, **kw)[0])
    return fwd(params, jnp.asarray(ids))


@pytest.fixture(scope="module", params=sorted(CASES))
def models(request):
    cb, layout, env = CASES[request.param]
    jcfg = JConfig(**DIMS)
    with _jax_env(env):
        params = JR.random_quantized_model(jcfg, cb, seed=0,
                                           dtype=jnp.float32,
                                           quantize_head=True)
    tcfg = qt.ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    return layout, jcfg, JM.fuse_for_inference(jcfg, params), tcfg, port


@pytest.mark.parametrize("S", [12, 40])
def test_generate_matches_jax(models, S):
    layout, jcfg, jparams, tcfg, port = models
    assert port.lm_head.qweight.layout == layout
    assert port.layers[0]["mlp"]["gateup_proj"].qweight.layout == layout
    new = 6
    prompt = np.random.default_rng(S).integers(0, 256, (1, S))
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt), new,
                                cache_len=64, dtype_str="float32"))
    got, logits = qt.generate(tcfg, port, torch.from_numpy(prompt), new,
                              cache_len=64, dtype=torch.float32,
                              device="cpu", return_logits=True)
    assert np.array_equal(got.numpy(), want)
    jl = _japply(jcfg, jparams, want[:, :-1], dtype=jnp.float32)
    jl = np.asarray(jl)[0, S - 1:]
    tl = torch.stack(logits, dim=1)[0].numpy()
    assert tl.shape == jl.shape == (new, 256) and np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


@pytest.mark.parametrize("codebook,layout", [("E8P12", "u3"),
                                             ("E8P12RVQ4B", "pb"),
                                             ("E8P12RVQ4B", None)])
def test_port_random_model_holds_valid_codes(codebook, layout):
    cfg = qt.ModelConfig(**{**DIMS, "num_hidden_layers": 1})
    model = qt.random_quantized_model(cfg, codebook, seed=1, device="cpu",
                                      quantize_head=True, layout=layout)
    lins = [model.lm_head] + [
        m for blk in model.layers for part in ("self_attn", "mlp")
        for m in blk[part].values()]
    for lin in lins:
        q = lin.qweight
        assert q.layout == (layout or "nibble") and q.codebook_id == codebook
        G = q.q_in // 8
        if layout == "u3":
            u, _ = tqt.u3_up_from_planes(q.planes)
            assert int(u[:, :G].max()) <= 5
        elif layout == "pb":
            u0, _, u1, _ = tqt.pb_uv_from_planes(q.planes)
            assert max(int(u0[:, :G].max()), int(u1[:, :G].max())) <= 5
        tqt.to_raw_idxs(q)                  # every group a real codeword
    fused = qt.fuse_for_inference(cfg, model)
    before = (rowpair_matmul.rowpair_u3_matmul.launches,
              rowpair_matmul.rowpair_pb_matmul.launches,
              fused_matmul.fused_decode_matmul.launches)
    prompt = torch.arange(12)[None]
    a = qt.generate(cfg, fused, prompt, 3, cache_len=32, dtype=torch.float32,
                    device="cpu")
    b = qt.generate(cfg, fused, prompt, 3, cache_len=32, dtype=torch.float32,
                    device="cpu", linear_kw={"matmul_impl": "plain"})
    assert torch.equal(a, b) and a.shape == (1, 15)
    assert (rowpair_matmul.rowpair_u3_matmul.launches,
            rowpair_matmul.rowpair_pb_matmul.launches,
            fused_matmul.fused_decode_matmul.launches) == before


def test_rowpair_experts_do_not_stack():
    """The port refuses u3 Mixtral experts. The JAX package stacks them in
    the u3 planes and its MoE kernel decodes those as nibble words: its
    fused tiny Mixtral then differs from the unfused one by more than half
    the logits' max (1.55 of it when measured)."""
    cfg = dict(DIMS, num_hidden_layers=1, num_local_experts=4,
               num_experts_per_tok=2)
    jcfg = JConfig(arch="mixtral", **cfg)
    with _jax_env({"QFA_E8P_U3": "1"}):
        params = JR.random_quantized_model(jcfg, "E8P12", seed=0,
                                           dtype=jnp.float32)
    fused = JM.fuse_for_inference(jcfg, params)
    st = fused["layers"][0]["block_sparse_moe"]["experts_stacked"]
    assert sorted(st["w13"].planes) == ["w0", "w1", "w2"]    # u3, unconverted
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 256, (1, 4)))
    ref = np.asarray(_japply(jcfg, params, ids, dtype=jnp.float32))
    bad = np.asarray(_japply(jcfg, fused, ids, dtype=jnp.float32))
    assert np.abs(bad - ref).max() > 0.5 * np.abs(ref).max()

    tcfg = qt.ModelConfig(arch="mixtral", **cfg)
    port = from_jax_params(params, "cpu")
    with pytest.raises(NotImplementedError, match="nibble"):
        qt.fuse_for_inference(tcfg, port)
    with pytest.raises(NotImplementedError, match="nibble"):
        qt.random_quantized_model(tcfg, device="cpu", layout="u3")
