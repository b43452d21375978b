"""LoRA through the port (nn/lora.py, quantize/lora_train.py) against the
JAX package on one tiny random E8P12 llama carried across with
``from_jax_params``: widths that are multiples of 128 (every quantized
linear takes the fused route, K2 forward and K3 backward), 2 layers, a
quantized head, batches of 2 x 17 tokens (32 rows per linear). Every
linear's wscale is scaled by 0.3 so that activations stay O(1) through the
random layers (loss ~10, not ~100): at full scale the attention softmax
saturates and amplifies f32 sum-order noise to ~1e-3 of a gradient.

Tolerances: in f32 compute the loss within 1e-5 of JAX's (relative) and
each adapter gradient within 1e-4 of the tensor's max (the transforms and
products sum in other orders); ``train_lora`` in f32 compute (the JAX
package's ``causal_lm_loss`` patched to name it, as it names no compute
dtype; the port's likewise) per-step losses within 1e-4 relative and final adapters within
1e-4 absolute (lr 1e-3: a tenth of one step; Adam's first steps are
+-lr whatever a gradient's size, so a relative bound on B means nothing
where a gradient element is near zero); greedy ids equal.
"""
import dataclasses
import logging
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.nn.qlinear import QuantLinearParams
from quip_for_all_tpu.quantize import lora_train as jtrain
from quip_for_all_tpu.runtime.generate import generate as jgenerate
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import lora as tlora
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.quantize import lora_train as ttrain
from quip_for_all_tpu_torch.runtime.generate import generate
from quip_for_all_tpu_torch.utils.convert import from_jax_params

pytestmark = pytest.mark.fast

DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=128)


def _rescale(node, f):
    if isinstance(node, QuantLinearParams):
        return dataclasses.replace(node, wscale_float=node.wscale_float * f)
    if isinstance(node, dict):
        return {k: _rescale(v, f) for k, v in node.items()}
    if isinstance(node, list):
        return [_rescale(v, f) for v in node]
    return node


@pytest.fixture(scope="module")
def jparams():
    return _rescale(random_quantized_model(
        JConfig(**DIMS), "E8P12", seed=0, dtype=jnp.float32,
        quantize_head=True), 0.3)


def _ids(seed, n=2, S=17):
    return np.random.default_rng(seed).integers(0, 256, (n, S)).astype(
        np.int32)


def _adapted(jparams, seed=3):
    """Both packages' models with the same adapters, B moved off zero so
    that A takes gradients too."""
    jp = jlora.add_lora(jparams, rank=4, seed=seed)
    model = tlora.add_lora(from_jax_params(jparams, "cpu"), rank=4,
                           seed=seed)
    jf = jlora.collect_lora_trainable(jp["layers"], "layers")
    rng = np.random.default_rng(seed + 1)
    newB = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in jf.items() if k.endswith("lora_B")}
    jp["layers"] = jlora.apply_lora_trainable(
        jp["layers"], {**jf, **{k: jnp.asarray(v) for k, v in newB.items()}},
        "layers")
    tlora.apply_lora_trainable(model.layers, newB, "layers")
    return jp, model


def test_zero_init_adapters_leave_the_logits_unchanged(jparams):
    model = from_jax_params(jparams, "cpu")
    ids = torch.from_numpy(_ids(2)).long()
    with torch.no_grad():
        l0, _ = TM.model_apply(ModelConfig(**DIMS), model, ids)
        tlora.add_lora(model, rank=4)
        l1, _ = TM.model_apply(ModelConfig(**DIMS), model, ids)
    assert type(model.layers[0]["self_attn"]["q_proj"]).__name__ == \
        "LoraLinear"
    assert torch.equal(l0, l1)


def test_add_lora_draws_jax_adapters_key_for_key(jparams):
    jf = jlora.collect_lora_trainable(
        jlora.add_lora(jparams, rank=8, alpha=16.0, seed=11)["layers"],
        "layers")
    model = tlora.add_lora(from_jax_params(jparams, "cpu"), rank=8,
                           alpha=16.0, seed=11)
    tf = tlora.collect_lora_trainable(model.layers, "layers")
    assert list(tf) == list(jf)
    assert len(tf) == 2 * 7 * DIMS["num_hidden_layers"]
    for k, v in jf.items():
        assert np.array_equal(tf[k].detach().numpy(), np.asarray(v)), k
        assert tf[k].requires_grad
    lin = model.layers[1]["mlp"]["down_proj"]
    assert float(lin.lora_scale) == 2.0 and not lin.lora_A.grad
    # everything outside the adapters is frozen
    assert {n for n, p in model.named_parameters() if p.requires_grad} == \
        set(tf)
    # fusion leaves LoRA-wrapped linears unfused
    fused = TM.fuse_for_inference(ModelConfig(**DIMS), model)
    assert "qkv_proj" not in fused.layers[0]["self_attn"]


def _jax_f32_loss(cfg, params, ids):
    """The JAX package's ``causal_lm_loss`` with the compute dtype f32."""
    logits, _ = JM.model_apply(cfg, params, ids[:, :-1], linear_kw={
        "training": False, "compute_dtype": jnp.float32})
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, ids[:, 1:, None], -1)[..., 0].mean()


def _jax_loss_and_grads(jp, ids):
    flat = jlora.collect_lora_trainable(jp["layers"], "layers")

    def loss(flat):
        p2 = dict(jp)
        p2["layers"] = jlora.apply_lora_trainable(jp["layers"], flat,
                                                  "layers")
        return _jax_f32_loss(JConfig(**DIMS), p2, ids)
    val, grads = jax.value_and_grad(loss)(flat)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_loss_and_adapter_grads_match_jax(jparams, route, monkeypatch):
    """Fused: every linear through the forward kernel's twin and K3's twin
    (12 backward calls: 7 linears x 2 layers + the head, less layer 0's
    q/k/v, whose input needs no gradient). Dense: the JAX package with
    QFA_FUSED_MAX_M=1, the port with max_m=1 (decoded W, no K3)."""
    jp, model = _adapted(jparams)
    ids = _ids(5)
    kw = {"compute_dtype": torch.float32}
    if route == "dense":
        monkeypatch.setenv("QFA_FUSED_MAX_M", "1")
        kw["max_m"] = 1
    want_loss, want = _jax_loss_and_grads(jp, jnp.asarray(ids))
    calls = []
    twin = tfm.fused_decode_matmul_bwd_ref
    monkeypatch.setattr(tfm, "fused_decode_matmul_bwd_ref",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    loss = ttrain.causal_lm_loss(ModelConfig(**DIMS), model,
                                 torch.from_numpy(ids), kw)
    loss.backward()
    assert len(calls) == (12 if route == "fused" else 0)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    got = tlora.collect_lora_trainable(model.layers, "layers")
    assert sorted(got) == sorted(want)      # jax.grad sorts dict keys
    for k, w in want.items():
        err = np.abs(got[k].grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err)


def _epoch_losses(caplog):
    out = []
    for rec in caplog.records:
        m = re.match(r"lora epoch \d+ train ([\d.]+)", rec.getMessage())
        if m:
            out.append(float(m.group(1)))
    return out


def test_train_lora_matches_jax(jparams, caplog, monkeypatch):
    """3 steps (3 epochs of one batch) with validation after each."""
    train, valid = _ids(7), _ids(8)
    caplog.set_level(logging.INFO)
    monkeypatch.setattr(jtrain, "causal_lm_loss", _jax_f32_loss)
    loss = ttrain.causal_lm_loss
    monkeypatch.setattr(ttrain, "causal_lm_loss", lambda c, m, ids: loss(
        c, m, ids, {"compute_dtype": torch.float32}))
    jp = jtrain.train_lora(JConfig(**DIMS), jparams, train,
                           valid_tokens=valid, rank=4, lr=1e-3, epochs=3,
                           batch_size=2, seed=1)
    want_losses = _epoch_losses(caplog)
    caplog.clear()
    model = ttrain.train_lora(ModelConfig(**DIMS),
                              from_jax_params(jparams, "cpu"), train,
                              valid_tokens=valid, rank=4, lr=1e-3, epochs=3,
                              batch_size=2, seed=1, device="cpu")
    got_losses = _epoch_losses(caplog)
    assert len(got_losses) == len(want_losses) == 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want = jlora.collect_lora_trainable(jp["layers"], "layers")
    got = tlora.collect_lora_trainable(model.layers, "layers")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k].detach().numpy() - np.asarray(w)).max()
        assert err <= 1e-4, (k, err)


def test_generate_with_adapters_matches_jax(jparams):
    """Greedy decoding through the unfused base linears plus the rank-r
    products, in f32 activations with the default bf16 compute."""
    jp, model = _adapted(jparams)
    prompt = _ids(9, n=1, S=12)
    want = np.asarray(jgenerate(JConfig(**DIMS), jp, jnp.asarray(prompt), 6,
                                cache_len=32, dtype_str="float32"))
    got = generate(ModelConfig(**DIMS), model, torch.from_numpy(prompt), 6,
                   cache_len=32, dtype=torch.float32, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_cpu_training_step_launches_nothing(jparams):
    before = (tfm.fused_decode_matmul.launches,
              tfm.fused_decode_matmul_bwd.launches)
    _, model = _adapted(jparams)
    ttrain.causal_lm_loss(ModelConfig(**DIMS), model,
                          torch.from_numpy(_ids(4))).backward()
    grads = [p.grad for p in tlora.collect_lora_trainable(
        model.layers, "layers").values()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert (tfm.fused_decode_matmul.launches,
            tfm.fused_decode_matmul_bwd.launches) == before
