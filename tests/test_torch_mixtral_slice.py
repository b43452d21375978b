"""The Mixtral slice end to end: a JAX random E8P12 tiny Mixtral (quantized
head) carried across with ``from_jax_params``, fused by each package (qkv
fused, experts stacked), and run through each package's ``generate`` in
float32; plus a JAX-quantized tiny Mixtral written by the JAX package's
``save_quantized`` and read by both packages' ``load_quantized``.

A 12-token prompt prefills through the sparse route (R = 24 rows) and a
40-token prompt through the dense masked expert loop; every decode step
takes the sparse route. Greedy ids must be identical; logits are compared
per step within 2e-2 * max|logit|, as tests/test_torch_slice.py holds them
(both packages round every quantized linear's output to bf16, the default
compute dtype, and f32 sum order can move a value to its bf16 neighbour).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.data.calibration import synthetic_tokens
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.quantize.quantizer import QuipQuantizer
from quip_for_all_tpu.runtime.generate import generate as jgenerate
from quip_for_all_tpu.utils import checkpoint as jckpt
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.ops import fused_matmul, moe_matmul
from quip_for_all_tpu_torch.ops.dequant import nibble_planes
from quip_for_all_tpu_torch.runtime.generate import generate
from quip_for_all_tpu_torch.utils.checkpoint import load_quantized
from quip_for_all_tpu_torch.utils.convert import from_jax_params

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

DIMS = dict(arch="mixtral", vocab_size=256, hidden_size=128,
            intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_local_experts=4,
            num_experts_per_tok=2)


def _japply(cfg, params, ids, **kw):
    """JAX's ``model_apply`` logits as one jitted forward: a few seconds
    of compile, where the eager forward compiles the interpret-mode
    kernels op by op (~4x longer on these models)."""
    fwd = jax.jit(lambda p, i: JM.model_apply(cfg, p, i, **kw)[0])
    return fwd(params, jnp.asarray(ids))


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    return jcfg, JM.fuse_for_inference(jcfg, params), tcfg, port


def test_port_model_is_fused_like_jax(models):
    jcfg, jparams, tcfg, port = models
    for jb, tb in zip(jparams["layers"], port.layers):
        assert sorted(jb["self_attn"]) == sorted(tb["self_attn"].keys())
        assert sorted(jb["block_sparse_moe"]) == sorted(
            tb["block_sparse_moe"].keys()) == ["experts_stacked", "gate"]
        assert sorted(tb["block_sparse_moe"]["experts_stacked"].keys()) == [
            "w13", "w2"]
    assert type(port.lm_head).__name__ == "QuantLinear"


def _logits_close(jcfg, jparams, ids, S, logits):
    """The JAX side's per-step logits from one causal forward over the
    generated ids (a decode step's logits are its prefix's last ones)."""
    jl = _japply(jcfg, jparams, ids[:, :-1], dtype=jnp.float32)
    jl = np.asarray(jl)[0, S - 1:]
    tl = torch.stack(logits, dim=1)[0].numpy()
    assert tl.shape == jl.shape and np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


@pytest.mark.parametrize("S", [12, 40])
def test_generate_matches_jax(models, S):
    jcfg, jparams, tcfg, port = models
    new = 8
    prompt = np.random.default_rng(S).integers(0, 256, (1, S))
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt), new,
                                cache_len=64, dtype_str="float32"))
    got, logits = generate(tcfg, port, torch.from_numpy(prompt), new,
                           cache_len=64, dtype=torch.float32, device="cpu",
                           return_logits=True)
    assert np.array_equal(got.numpy(), want)
    _logits_close(jcfg, jparams, want, S, logits)


def test_plain_route_equals_default_route_on_cpu(models):
    """On CPU tensors both wrappers already run their plain twins, so
    forcing the plain route changes nothing and launches nothing."""
    _, _, tcfg, port = models
    prompt = torch.arange(12)[None]
    before = (fused_matmul.fused_decode_matmul.launches,
              moe_matmul.moe_fused_matmul.launches)
    a = generate(tcfg, port, prompt, 4, cache_len=64, dtype=torch.float32,
                 device="cpu")
    b = generate(tcfg, port, prompt, 4, cache_len=64, dtype=torch.float32,
                 device="cpu", linear_kw={"matmul_impl": "plain"})
    assert torch.equal(a, b)
    assert (fused_matmul.fused_decode_matmul.launches,
            moe_matmul.moe_fused_matmul.launches) == before


def test_random_mixtral_is_seeded_stacked_and_valid():
    """The port's own random Mixtral: seeded, experts stacked per layer,
    real E8P12 words, and it runs through generate on the CPU."""
    cfg = qt.ModelConfig(**DIMS)
    a = qt.random_quantized_model(cfg, seed=3, device="cpu",
                                  quantize_head=True)
    b = qt.random_quantized_model(cfg, seed=3, device="cpu",
                                  quantize_head=True)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    moe = a.layers[0]["block_sparse_moe"]
    assert sorted(moe.keys()) == ["experts_stacked", "gate"]
    w13 = moe["experts_stacked"]["w13"]
    assert (w13.E, w13.nseg, w13.seg_out) == (4, 2, 384)
    nibs = torch.stack(nibble_planes(w13.planes_w0[:, :, :16]), dim=-1)
    assert int(nibs.max()) <= 11
    f = qt.fuse_for_inference(cfg, a)
    assert sorted(f.layers[0]["self_attn"].keys()) == ["o_proj", "qkv_proj"]
    assert f.layers[0]["block_sparse_moe"] is moe
    ids = qt.generate(cfg, f, torch.arange(12)[None], 3, cache_len=32,
                      dtype=torch.float32, device="cpu")
    assert ids.shape == (1, 15)


@pytest.fixture(scope="module")
def saved_mixtral(tmp_path_factory):
    """A tiny Mixtral quantized by the JAX package (real E8P12 codewords,
    router gate left dense) and written in the reference schema."""
    jcfg = JConfig(**DIMS)
    params = JM.init_llama_params(jcfg, seed=0)
    calib = synthetic_tokens(8, 24, jcfg.vocab_size, seed=1)
    q = QuipQuantizer(codebook="E8P12", nsamples=8, batch_size=4,
                      quip_tune_iters=0, ft_epochs=0,
                      modules_to_not_convert=["gate"])
    qparams = q.quantize_model(jcfg, params, calib)
    d = str(tmp_path_factory.mktemp("mixtral") / "ckpt")
    jckpt.save_quantized(jcfg, qparams, q.to_dict(), d)
    return d


def test_load_quantized_mixtral_matches_jax(saved_mixtral):
    jcfg, jparams, _ = jckpt.load_quantized(saved_mixtral)
    tcfg, model, qcfg = load_quantized(saved_mixtral, device="cpu")
    assert tcfg.arch == "mixtral" and tcfg.num_local_experts == 4
    moe = model.layers[0]["block_sparse_moe"]
    assert type(moe["gate"]).__name__ == "DenseLinear"
    assert len(moe["experts"]) == 4
    assert type(moe["experts"][2]["w3"]).__name__ == "QuantLinear"
    ids = synthetic_tokens(2, 12, jcfg.vocab_size, 3)
    want = _japply(jcfg, jparams, ids,
                   linear_kw={"compute_dtype": jnp.float32})
    got, _ = TM.model_apply(tcfg, model, torch.from_numpy(np.asarray(ids)),
                            linear_kw={"compute_dtype": torch.float32})
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("S", [12, 40])
def test_loaded_mixtral_generates_like_jax(saved_mixtral, S):
    """Loaded, fused (experts stacked) and generated by each package: the
    same greedy ids in the default bf16 compute. Logits are held in f32
    compute (1e-3 * max, sum order only): with bf16 linear outputs the two
    packages' router logits differ by up to ~1e-2 on this model, and at
    12 tokens one position's 2nd and 3rd experts lie closer than that, so
    top-2 routing may flip there (a near-tie, not a fault)."""
    jcfg, jparams, _ = jckpt.load_quantized(saved_mixtral)
    jparams = JM.fuse_for_inference(jcfg, jparams)
    tcfg, model, _ = load_quantized(saved_mixtral, device="cpu")
    model = TM.fuse_for_inference(tcfg, model)
    assert "experts_stacked" in model.layers[1]["block_sparse_moe"]
    prompt = torch.from_numpy(np.random.default_rng(S + 1).integers(
        0, 256, (1, S)))
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt.numpy()),
                                6, cache_len=64, dtype_str="float32"))
    got = generate(tcfg, model, prompt, 6, cache_len=64,
                   dtype=torch.float32, device="cpu")
    assert np.array_equal(got.numpy(), want)

    ids, logits = generate(tcfg, model, prompt, 6, cache_len=64,
                           dtype=torch.float32, device="cpu",
                           return_logits=True,
                           linear_kw={"compute_dtype": torch.float32})
    jl = _japply(jcfg, jparams, ids.numpy()[:, :-1], dtype=jnp.float32,
                 linear_kw={"compute_dtype": jnp.float32})
    jl = np.asarray(jl)[0, S - 1:]
    tl = torch.stack(logits, dim=1)[0].numpy()
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 1e-3 * np.abs(jl).max(axis=-1)), err
