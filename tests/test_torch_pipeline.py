"""The GPipe pipeline (``parallel/pipeline.py`` ``pipeline_logits``) on
gloo ranks on the CPU, held to the JAX package's
``quip_for_all_tpu/parallel/pipeline.py`` on its 8-device CPU mesh, and
its gradients held to the one-rank step's.

Four ranks are spawned once for the file (``tests/torch_tp_cases.py``); a
pp of 2 runs on each half of them. Logits hold to JAX's pipelined logits
within ``MODEL_TOL`` of max|logit| plus one ulp (f32 compute in the
linears): a float llama at (pp, microbatches) = (2, 2), (4, 4) and (4, 2)
(``tests/test_pipeline.py``'s cases), a quantized E8P12 llama with a
quantized head, and GPT-NeoX. Every rank returns the same logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn.qlinear import QuantLinearParams
from quip_for_all_tpu.parallel import pipeline as JP
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.parallel.pipeline import pipeline_logits
from quip_for_all_tpu_torch.parallel.sharding import AxisMesh
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


LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256)


def _rescale(node, f):
    if isinstance(node, QuantLinearParams):
        return dataclasses.replace(node, wscale_float=node.wscale_float * f)
    if isinstance(node, dict):
        return {k: _rescale(v, f) for k, v in node.items()}
    if isinstance(node, list):
        return [_rescale(v, f) for v in node]
    return node


def _llama(quantized: bool, wscale: float = 1.0):
    """A float llama (JAX's init) or a random E8P12 one with a quantized
    head, its wscale times ``wscale`` (0.3 keeps the activations O(1), as
    in ``tests/test_torch_lora.py``: f32 gradient parity needs it)."""
    jcfg, tcfg = JConfig(**LLAMA), ModelConfig(**LLAMA)
    jp = (_rescale(random_quantized_model(
        jcfg, "E8P12", seed=0, dtype=jnp.float32, quantize_head=True),
        wscale) if quantized else JM.init_llama_params(jcfg, seed=0))
    return jcfg, jp, tcfg, from_jax_params(jp, "cpu", tcfg)


def _jax_pp(jcfg, jp, ids, pp, M):
    mesh = JP.make_pp_mesh(pp)
    fn = jax.jit(lambda p, i: JP.pipeline_logits(jcfg, p, i, mesh, M,
                                                 linear_kw=F32))
    return np.asarray(fn(jp, jnp.asarray(ids)))


def _run(ranks, jcfg, jp, tcfg, port, ids, pp, M):
    want = _jax_pp(jcfg, jp, ids, pp, M)
    path = C.save_model(ranks, "model", port)
    outs = ranks.run("torch_sp_cases:pp_logits", tcfg, path, ids, pp, M, T32)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0], outs[0][0])
    assert_close(outs[0][0], want, rel=MODEL_TOL)
    return outs[0][1]


@pytest.mark.parametrize("pp,M", [(2, 2), (4, 4), (4, 2)])
def test_pipeline_logits_match_jax_float(ranks, pp, M):
    jcfg, jp, tcfg, port = _llama(False)
    B, S = 4, 12
    ids = np.arange(B * S).reshape(B, S) % jcfg.vocab_size
    counts = _run(ranks, jcfg, jp, tcfg, port, ids, pp, M)
    # a stage's output moves on at every step but the last; the outputs
    # leave the last stage by one broadcast
    assert counts["ring_shift"] == M + pp - 2
    assert counts["broadcast"] == 1


def test_pipeline_logits_quantized_head(ranks):
    jcfg, jp, tcfg, port = _llama(True)
    ids = np.arange(4 * 8).reshape(4, 8) % jcfg.vocab_size
    _run(ranks, jcfg, jp, tcfg, port, ids, 2, 2)


def test_pipeline_logits_gpt_neox(ranks):
    jcfg, jp, tcfg, port = FC.case("gpt_neox", base=dict(
        FC.BASE, num_hidden_layers=4))
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 10))
    _run(ranks, jcfg, jp, tcfg, port, ids, 4, 2)


@pytest.mark.parametrize("kernels", [False, True])
def test_pipelined_step_gradients_match_one_rank(ranks, kernels):
    """One finetune step pipelined over 2 stages (2 microbatches) against
    the one-rank step on the same model: the loss and every leaf's
    gradient, each on the rank of its stage, within 1e-4 of its max|grad|
    (the quantizer's training forward, or the eval forward through the
    kernels' route). A replication whose backward summed the ranks'
    cotangents would make the last stage's gradients 2x."""
    jcfg, jp, tcfg, port = _llama(True, wscale=0.3)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, jcfg.vocab_size, (4, 8))
    tgt = rng.random((4, 8, jcfg.vocab_size)).astype(np.float32)
    tgt /= tgt.sum(-1, keepdims=True)
    path = C.save_model(ranks, "model", port)
    one = ranks.run("torch_sp_cases:ft_step", tcfg, path, ids, tgt, 1, 1,
                    kernels)[0]
    outs = ranks.run("torch_sp_cases:ft_step", tcfg, path, ids, tgt, 2, 2,
                     kernels)
    per = tcfg.num_hidden_layers // 2
    for r, (loss, grads, counts) in enumerate(outs[:2]):
        assert loss == pytest.approx(one[0], rel=1e-6)
        mine = sorted(k for k in one[1]
                      if int(k.split(".", 2)[1]) // per == r)
        assert sorted(grads) == mine
        for k in mine:
            g = one[1][k]
            err = np.abs(grads[k] - g).max()
            assert err <= 1e-4 * np.abs(g).max(), (k, err)
        # two shifts forward and two back; no gradient for the ids'
        # embedding, so no broadcast of it
        assert counts["ring_shift"] == 4 and counts["broadcast"] == 1


def test_pipeline_forward_gradient_in_its_input(ranks):
    """``pipeline_forward`` differentiated in its input activations too
    (every rank gets stage 0's gradient, by one broadcast beside the
    outputs' one) and in the leaves, against the blocks in turn on one
    rank, microbatch by microbatch: within 1e-4 of the max gradient. (The
    whole batch at once sums the leaves' gradients in another order; with
    this loss's signed weights that alone parts them by 2.6e-4.)"""
    jcfg, jp, tcfg, port = _llama(True, wscale=0.3)
    x = np.random.default_rng(8).standard_normal(
        (4, 6, tcfg.hidden_size)).astype(np.float32)
    path = C.save_model(ranks, "model", port)
    for dx_err, leaf_err, broadcasts in ranks.run(
            "torch_sp_cases:pp_input_grad", tcfg, path, x, 2, 2):
        assert dx_err <= 1e-4 and leaf_err <= 1e-4
        assert broadcasts == 2


def test_pipeline_refusals():
    """As JAX's: a batch that does not split into the microbatches
    (JAX asserts), layers that do not split over the stages (JAX's
    shard_map refuses the stacked axis); the port raises ValueError before
    any collective, so a mesh object of no group serves."""
    jcfg, jp, tcfg, port = _llama(False)
    ids = np.zeros((3, 8), np.int64)
    mesh = AxisMesh("pp", 2, 0, None, (0, 1))
    with pytest.raises(ValueError, match="batch 3 must divide into 2"):
        pipeline_logits(tcfg, port, torch.as_tensor(ids), mesh, 2)
    with pytest.raises(AssertionError):
        JP.pipeline_logits(jcfg, jp, jnp.asarray(ids), JP.make_pp_mesh(2), 2)
    mesh3 = AxisMesh("pp", 3, 0, None, (0, 1, 2))
    with pytest.raises(ValueError, match="pp=3 must divide the 4 layers"):
        pipeline_logits(tcfg, port, torch.zeros((3, 8), dtype=torch.long),
                        mesh3, 3)
    with pytest.raises(ValueError, match="not evenly divisible"):
        JP.pipeline_logits(jcfg, jp, jnp.zeros((3, 8), jnp.int32),
                           JP.make_pp_mesh(3), 3)
