"""LoRA on Mixtral against the JAX package: a tiny random E8P12 Mixtral
(4 experts, top-2, widths that are multiples of 128, so every quantized
linear takes the fused route: the forward kernel's twin and K3's twin) with
its experts stacked and its attention unfused, as a LoRA user runs it.
Batches of 2 x 17 tokens give the MoE block 32 tokens: the dense expert
loop over the stacked experts' per-expert views, where JAX trains too.
Every linear's wscale is scaled by 0.1 so that activations stay O(1)
through the random layers (the reason in ``tests/test_torch_lora.py``):
at 0.3, the llama test's factor, this model's attention scores reach ~180
in layer 1 and the saturated softmax amplifies f32 sum-order noise to
~1e-4 of a q/k adapter gradient (the JAX package's own stacked and
unstacked forms of one model differ by 4e-5 there); at 0.1 the scores
stay near 20, the loss near ln(256), and the packages agree to ~2e-5.

Also the route of the MoE block in a training forward below 32 tokens
(``linear_kw["training"]``): the dense loop in both packages, as JAX's
``moe_apply`` takes it (``quip_for_all_tpu/models/llama.py:215``).

Tolerances (f32 compute): the MoE block's output within 1e-5 of its max;
the loss within 1e-5 relative and each adapter gradient within 1e-4 of
its max; ``train_lora``'s per-epoch losses within 1e-4 relative and its
adapters within 1e-4 absolute (``tests/test_torch_lora.py`` says why);
greedy ids in the default bf16 compute equal or forked at bf16 ties only
(``torch_family_cases.assert_ids_agree``).
"""
import dataclasses
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.nn import qmoe as jqmoe
from quip_for_all_tpu.nn.qlinear import QuantLinearParams
from quip_for_all_tpu.quantize import lora_train as jtrain
from quip_for_all_tpu.runtime import generate as JG
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import lora as tlora
from quip_for_all_tpu_torch.nn import qmoe as tqmoe
from quip_for_all_tpu_torch.quantize import lora_train as ttrain
from quip_for_all_tpu_torch.runtime import generate as G
from quip_for_all_tpu_torch.utils.convert import from_jax_params

from torch_family_cases import assert_ids_agree
from torch_lora_cases import (_epoch_losses, jax_f32_loss,
                              jax_loss_and_grads, routes)

pytestmark = pytest.mark.fast

DIMS = dict(arch="mixtral", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=128, num_local_experts=4,
            num_experts_per_tok=2)
JCFG, TCFG = JConfig(**DIMS), ModelConfig(**DIMS)
ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
EXPERTS = ("w1", "w2", "w3")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The JAX tree, experts unstacked (as loaded)."""
    return _rescale(random_quantized_model(
        JCFG, "E8P12", seed=0, dtype=jnp.float32, quantize_head=True), 0.1)


def _stack(jp):
    """The JAX tree with every layer's experts stacked and the attention
    left unfused."""
    out = dict(jp)
    out["layers"] = [dict(b, block_sparse_moe={
        "gate": b["block_sparse_moe"]["gate"],
        "experts_stacked": jqmoe.stack_experts(b["block_sparse_moe"])})
        for b in jp["layers"]]
    return out


def _port(jp, stacked):
    """The port's model of the unstacked JAX tree, its experts stacked by
    the port's own ``stack_experts`` where ``stacked``."""
    model = from_jax_params(jp, "cpu", TCFG)
    if stacked:
        for blk in model.layers:
            moe = blk["block_sparse_moe"]
            blk["block_sparse_moe"] = nn.ModuleDict({
                "gate": moe["gate"],
                "experts_stacked": nn.ModuleDict(tqmoe.stack_experts(moe))})
    return model


def _ids(seed, n=2, S=17):
    return np.random.default_rng(seed).integers(0, 256, (n, S)).astype(
        np.int32)


def _adapted(jparams, targets, stacked, seed=3):
    """Both packages' models with the same adapters, B moved off zero."""
    jp = jlora.add_lora(_stack(jparams) if stacked else jparams, rank=4,
                        targets=targets, seed=seed)
    model = tlora.add_lora(_port(jparams, stacked), rank=4, targets=targets,
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


def test_training_forward_below_32_tokens_takes_the_dense_loop(
        jparams, monkeypatch):
    """``moe_apply`` of a stacked Mixtral on 16 tokens with
    ``linear_kw={"training": True}``: neither package takes the sparse
    route (each one's ``moe_sparse_apply`` is made to raise), the outputs
    agree, and the port's gradient reaches x."""
    def refuse(*a, **k):
        raise AssertionError("the sparse MoE route in a training forward")
    monkeypatch.setattr(jqmoe, "moe_sparse_apply", refuse)
    monkeypatch.setattr(TM, "moe_sparse_apply", refuse)
    jmoe = _stack(jparams)["layers"][0]["block_sparse_moe"]
    tmoe = _port(jparams, True).layers[0]["block_sparse_moe"]
    x = np.random.default_rng(1).standard_normal((2, 8, 128)).astype(
        np.float32)
    want = np.asarray(JM.moe_apply(JCFG, jmoe, jnp.asarray(x), {
        "training": True, "compute_dtype": jnp.float32}, None))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TM.moe_apply(TCFG, tmoe, xt, {"training": True,
                                        "compute_dtype": torch.float32})
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    got.square().sum().backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().max() > 0


@pytest.mark.parametrize("stacked", [True, False])
def test_add_lora_draws_jax_adapters_key_for_key(jparams, stacked):
    """Targets naming the attention and the experts' w1/w2/w3: on stacked
    experts only the attention takes adapters in both packages (JAX's walk
    passes ``experts_stacked`` by); on unstacked ones every expert linear
    does too. A drawn bitwise, key for key."""
    targets = ATTN + EXPERTS
    jp = jlora.add_lora(_stack(jparams) if stacked else jparams, rank=8,
                        targets=targets, seed=11)
    jf = jlora.collect_lora_trainable(jp["layers"], "layers")
    model = tlora.add_lora(_port(jparams, stacked), rank=8, targets=targets,
                           seed=11)
    tf = tlora.collect_lora_trainable(model.layers, "layers")
    assert list(tf) == list(jf)
    per_layer = 4 + (0 if stacked else 3 * DIMS["num_local_experts"])
    assert len(tf) == 2 * per_layer * DIMS["num_hidden_layers"]
    assert any(".experts." in k for k in tf) != stacked
    for k, v in jf.items():
        assert np.array_equal(tf[k].detach().numpy(), np.asarray(v)), k
    assert {n for n, p in model.named_parameters() if p.requires_grad} == \
        set(tf)


@pytest.mark.parametrize("stacked", [True, False])
def test_loss_grads_and_routes_match_jax(jparams, stacked, monkeypatch):
    """One f32 step at 32 MoE tokens (the dense expert loop): the loss,
    every adapter gradient, and the route of every quantized product in
    call order, all fused (the router is a dense linear). Adapters on the
    attention and, unstacked, on the experts too."""
    targets = ATTN if stacked else ATTN + EXPERTS
    jp, model = _adapted(jparams, targets, stacked)
    x = _ids(5)
    rec = routes(monkeypatch)
    want_loss, want = jax_loss_and_grads(JCFG, jp, jnp.asarray(x))
    loss = ttrain.causal_lm_loss(TCFG, model, torch.from_numpy(x),
                                 {"compute_dtype": torch.float32})
    fwd = list(rec["port"])
    loss.backward()
    E, L = DIMS["num_local_experts"], DIMS["num_hidden_layers"]
    assert fwd == rec["jax"] and len(fwd) == L * (4 + 3 * E) + 1
    assert all(r[0] == "fused" for r in fwd)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    got = tlora.collect_lora_trainable(model.layers, "layers")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k].grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err)


def test_train_lora_matches_jax(jparams, caplog, monkeypatch):
    """3 epochs of one 2 x 17 batch with validation after each, adapters
    on the attention of the stacked model (the default targets)."""
    train, valid = _ids(7), _ids(8)
    caplog.set_level(logging.INFO)
    monkeypatch.setattr(jtrain, "causal_lm_loss", jax_f32_loss)
    loss = ttrain.causal_lm_loss
    monkeypatch.setattr(ttrain, "causal_lm_loss", lambda c, m, x: loss(
        c, m, x, {"compute_dtype": torch.float32}))
    kw = dict(valid_tokens=valid, rank=4, lr=1e-3, epochs=3, batch_size=2,
              seed=1)
    jp = jtrain.train_lora(JCFG, _stack(jparams), train, **kw)
    want_losses = _epoch_losses(caplog)
    caplog.clear()
    model = ttrain.train_lora(TCFG, _port(jparams, True), train,
                              device="cpu", **kw)
    got_losses = _epoch_losses(caplog)
    assert len(got_losses) == len(want_losses) == 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want = jlora.collect_lora_trainable(jp["layers"], "layers")
    got = tlora.collect_lora_trainable(model.layers, "layers")
    assert list(got) == list(want) and len(got) == 16
    for k, w in want.items():
        err = np.abs(got[k].detach().numpy() - np.asarray(w)).max()
        assert err <= 1e-4, (k, err)


def test_generate_with_adapters_matches_jax(jparams):
    """Greedy decoding with attention adapters on the stacked model: the
    32-token prompt through the dense expert loop, each step through the
    sparse route (the MoE kernel's twin), f32 activations, bf16 compute."""
    jp, model = _adapted(jparams, ATTN, True)
    prompt = _ids(9, n=1, S=32)
    want = np.asarray(JG.generate(JCFG, jp, jnp.asarray(prompt), 6,
                                  cache_len=64, dtype_str="float32"))
    got = G.generate(TCFG, model, torch.from_numpy(prompt), 6, cache_len=64,
                     dtype=torch.float32, device="cpu")
    assert_ids_agree(JCFG, jp, 32, got.numpy()[0], want[0])


def test_adapter_files_cross_between_the_packages(jparams, tmp_path):
    """The port's ``save_lora`` and ``export_peft`` files read by the JAX
    package onto its stacked tree, bit-equal, and the JAX package's read
    by the port; the loaded adapters give JAX's f32 logits."""
    jp, model = _adapted(jparams, ATTN, True)
    want = {k: np.asarray(v) for k, v in jlora.collect_lora_trainable(
        jp["layers"], "layers").items()}
    ttrain.save_lora(model, str(tmp_path / "native"), rank=4, alpha=16.0)
    ttrain.export_peft(model, str(tmp_path / "peft"), rank=4, alpha=16.0)
    jtrain.export_peft(jp, str(tmp_path / "jax_peft"), rank=4, alpha=16.0)
    for back in (jtrain.load_lora(_stack(jparams), str(tmp_path / "native")),
                 jtrain.import_peft(_stack(jparams), str(tmp_path / "peft"))):
        flat = jlora.collect_lora_trainable(back["layers"], "layers")
        assert list(flat) == list(want)
        for k, v in want.items():
            assert np.array_equal(np.asarray(flat[k]), v), k
    loaded = ttrain.import_peft(_port(jparams, True),
                                str(tmp_path / "jax_peft"), device="cpu")
    assert sorted(os.listdir(tmp_path / "peft")) == sorted(
        os.listdir(tmp_path / "jax_peft"))
    x = _ids(2, S=40)
    ref, _ = JM.model_apply(JCFG, jp, jnp.asarray(x),
                            linear_kw={"compute_dtype": jnp.float32})
    with torch.no_grad():
        got, _ = TM.model_apply(TCFG, loaded, torch.from_numpy(x).long(),
                                linear_kw={"compute_dtype": torch.float32})
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
