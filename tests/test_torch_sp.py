"""Sequence parallelism (``parallel/sequence.py``: ring attention,
``sequence_parallel_logits``; ``runtime/generate.py`` ``perplexity(
sp_mesh=)``) on gloo ranks on the CPU, held to the JAX package's
``quip_for_all_tpu/parallel/sequence.py`` on its 8-device CPU mesh.

Four ranks are spawned once for the file (``tests/torch_tp_cases.py``);
an sp of 2 runs on each half of them. Ring attention holds to JAX's under
``shard_map`` and to full causal attention within 2e-5 (rtol and atol,
``tests/test_sequence_parallel.py``'s rule); logits hold to JAX's
sequence-parallel logits within ``MODEL_TOL`` of max|logit| plus one ulp
(f32 compute in the linears), on the families JAX routes through sp: a
float llama, a quantized llama with fused qkv and gate/up, Baichuan's
``W_pack`` and GPT-NeoX with either residual.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.parallel import sequence as JS
from quip_for_all_tpu.parallel.pipeline import shard_map
from quip_for_all_tpu.runtime import generate as JG
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.parallel.sequence import sequence_parallel_logits
from quip_for_all_tpu_torch.parallel.sharding import AxisMesh
from quip_for_all_tpu_torch.runtime import generate as G
from quip_for_all_tpu_torch.utils.convert import from_jax_params

import torch_family_cases as FC
import torch_tp_cases as C
from torch_family_cases import F32, MODEL_TOL, T32, assert_close

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(4)
    yield r
    r.close()


def _full_causal(q, k, v):
    """Full-sequence causal attention (GQA) in f32 numpy, (B, S, H * hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.reshape(B, S, KV, G, hd).transpose(0, 2, 3, 1, 4) / np.sqrt(hd)
    s = np.einsum("bkgqh,bkth->bkgqt", qf, k.transpose(0, 2, 1, 3))
    i = np.arange(S)
    s = np.where((i[:, None] >= i[None, :]), s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    o = np.einsum("bkgqt,bkth->bkgqh", w, v.transpose(0, 2, 1, 3))
    return o.transpose(0, 3, 1, 2, 4).reshape(B, S, H * hd)


@pytest.mark.parametrize("sp,KV", [(2, 2), (4, 2), (4, 4)])
def test_ring_attention_matches_jax(ranks, sp, KV):
    rng = np.random.default_rng(0)
    B, S, H, hd = 2, 32, 4, 8
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    fn = shard_map(lambda q, k, v: JS.ring_attention(q, k, v),
                   mesh=JS.make_sp_mesh(sp),
                   in_specs=(P(None, "sp"), P(None, "sp"), P(None, "sp")),
                   out_specs=P(None, "sp"), check_rep=False)
    want = np.asarray(fn(q, k, v)).reshape(B, S, H * hd)
    outs = ranks.run("torch_sp_cases:ring", sp, q, k, v)[:sp]
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _full_causal(q, k, v), rtol=2e-5,
                               atol=2e-5)


LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256)


def _llama(kind):
    """A float llama (JAX's init) or a quantized one with fused qkv and
    gate/up and a quantized head."""
    jcfg, tcfg = JConfig(**LLAMA), ModelConfig(**LLAMA)
    if kind == "float":
        jp = JM.init_llama_params(jcfg, seed=0)
        return jcfg, jp, tcfg, from_jax_params(jp, "cpu", tcfg)
    jp = random_quantized_model(jcfg, "E8P12", seed=0, dtype=jnp.float32,
                                quantize_head=True)
    port = TM.fuse_for_inference(tcfg, from_jax_params(jp, "cpu", tcfg))
    return jcfg, JM.fuse_for_inference(jcfg, jp), tcfg, port


def _model(kind):
    if kind in ("float", "fused"):
        return _llama(kind)
    return FC.case(kind)


def _jax_sp(jcfg, jp, ids, sp):
    mesh = JS.make_sp_mesh(sp)
    fn = jax.jit(lambda p, i: JS.sequence_parallel_logits(
        jcfg, p, i, mesh, linear_kw=F32))
    return np.asarray(fn(jp, jnp.asarray(ids)))


@pytest.mark.parametrize("kind", ["float", "fused", "baichuan", "gpt_neox",
                                  "gpt_neox_seq"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sequence_parallel_logits_match_jax(ranks, kind, sp):
    jcfg, jp, tcfg, port = _model(kind)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 16))
    want = _jax_sp(jcfg, jp, ids, sp)
    path = C.save_model(ranks, "model", port)
    outs = ranks.run("torch_sp_cases:sp_logits", tcfg, path, ids, sp, T32)
    got = np.concatenate([o[0] for o in outs[:sp]], axis=1)
    assert_close(got, want, rel=MODEL_TOL)
    # one ring rotation of K and V a layer for each rank after the first
    assert outs[0][1]["ring_shift"] == (sp - 1) * tcfg.num_hidden_layers
    if sp == 2:     # the other group of two ranks computed the same
        np.testing.assert_array_equal(outs[2][0], outs[0][0])


def test_perplexity_sp_mesh_matches_jax(ranks):
    """``perplexity(sp_mesh=)``: every rank returns the same value; in the
    default bf16 compute within 1e-2 (relative) of the JAX package's on
    its sp mesh (the rule of ``tests/test_torch_cli.py``'s perplexity),
    and in f32 compute within 1e-5 of the port's one-rank perplexity. The
    float llama: the random quantized one's perplexity is ~1e60."""
    jcfg, jp, tcfg, port = _llama("float")
    windows = np.random.default_rng(4).integers(0, jcfg.vocab_size, (5, 16))
    want = JG.perplexity(jcfg, jp, windows, batch_size=2,
                         sp_mesh=JS.make_sp_mesh(4))
    path = C.save_model(ranks, "model", port)
    got = ranks.run("torch_sp_cases:sp_perplexity", tcfg, path, windows, 4,
                    2, None)
    assert len(set(got)) == 1
    assert got[0] == pytest.approx(want, rel=1e-2)
    got = ranks.run("torch_sp_cases:sp_perplexity", tcfg, path, windows, 4,
                    2, T32)
    assert len(set(got)) == 1
    one = G.perplexity(tcfg, port, windows, batch_size=2, device="cpu",
                       linear_kw=T32)
    assert got[0] == pytest.approx(one, rel=1e-5)


def test_sequence_parallel_refusals():
    """As JAX's: a sequence that does not split over sp, a family outside
    the llama family and GPT-NeoX (JAX asserts; the port raises
    ValueError). Both raise before any collective, so a mesh object of
    no group serves."""
    mesh = AxisMesh("sp", 3, 0, None, (0, 1, 2))
    _, _, tcfg, port = _llama("float")
    with pytest.raises(ValueError, match="must divide by sp=3"):
        sequence_parallel_logits(tcfg, port, torch.zeros((1, 16),
                                                         dtype=torch.long),
                                 mesh)
    with pytest.raises(AssertionError):
        JS.sequence_parallel_logits(JConfig(**LLAMA), {},
                                    jnp.zeros((1, 16), jnp.int32),
                                    JS.make_sp_mesh(3))
    jcfg, _, gcfg, gpt2 = FC.case("gpt2")
    with pytest.raises(ValueError, match="not 'gpt2'"):
        sequence_parallel_logits(gcfg, gpt2, torch.zeros((1, 6),
                                                         dtype=torch.long),
                                 mesh)
    with pytest.raises(AssertionError):
        JS.sequence_parallel_logits(jcfg, {}, jnp.zeros((1, 6), jnp.int32),
                                    JS.make_sp_mesh(3))
