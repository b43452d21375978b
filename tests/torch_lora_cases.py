"""LoRA on the families other than llama, shared by
``tests/test_torch_lora_families_*.py``: each family of
``tests/torch_family_cases.py`` (GPT-NeoX with both residuals, Falcon with
one KV head and with the new decoder, Baichuan's ``W_pack``) at widths
where the quantized linears take the fused route (``WIDE``: hidden 128,
FFN 256, 2 layers, 4 heads, vocabulary 256, so the forward kernel's twin
and K3's twin), except Falcon's one-KV-head qkv (192 rows: the dense route
in both packages). Adapters go on every linear of a block (``TARGETS``,
each family's own names for ``--targets``); weights cross over through
``from_jax_params``.

Every quantized product of a forward is recorded in both packages
(``routes``: the fused route or the dense one, with its shape), so a test
holds the port's route per linear to JAX's.

Compute in f32 in both packages: the JAX package's ``causal_lm_loss``
names no compute dtype, so its f32 twin ``jax_f32_loss`` is patched in
(as ``tests/test_torch_lora.py`` does for llama).
"""
import functools
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops import quant_matmul as jqm
from quip_for_all_tpu.quantize import lora_train as jtrain

from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.nn import lora as tlora
from quip_for_all_tpu_torch.nn import qlinear as tql
from quip_for_all_tpu_torch.ops import quant_matmul as tqm
from quip_for_all_tpu_torch.quantize import lora_train as ttrain
from quip_for_all_tpu_torch.utils.convert import from_jax_params

from torch_family_cases import BASE, case

WIDE = dict(BASE, hidden_size=128, intermediate_size=256)

# each family's block linears, by the suffixes ``add_lora`` matches
TARGETS = {
    "gpt2": ("c_attn", "c_proj", "c_fc"),
    "gpt_neox": ("query_key_value", "dense", "dense_h_to_4h",
                 "dense_4h_to_h"),
    "gpt_neox_seq": ("query_key_value", "dense", "dense_h_to_4h",
                     "dense_4h_to_h"),
    "opt": ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"),
    "falcon": ("query_key_value", "dense", "dense_h_to_4h", "dense_4h_to_h"),
    "falcon_new": ("query_key_value", "dense", "dense_h_to_4h",
                   "dense_4h_to_h"),
    "phi": ("q_proj", "k_proj", "v_proj", "dense", "fc1", "fc2"),
    "gptj": ("q_proj", "k_proj", "v_proj", "out_proj", "fc_in", "fc_out"),
    "qwen": ("c_attn", "c_proj", "w1", "w2"),
    "baichuan": ("W_pack", "o_proj", "gate_proj", "up_proj", "down_proj"),
}
# linears per block: GPT-2's and QWen's c_proj suffix matches two each
PER_BLOCK = {"gpt2": 4, "gpt_neox": 4, "gpt_neox_seq": 4, "opt": 6,
             "falcon": 4, "falcon_new": 4, "phi": 6, "gptj": 6, "qwen": 5,
             "baichuan": 5}
# the families whose linears the default (llama) targets miss entirely
DEFAULTS_MATCH_NOTHING = ("gpt2", "gpt_neox", "gpt_neox_seq", "falcon",
                          "falcon_new", "qwen")
RANK = 4


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(JAX config, JAX tree, port config) of a family at ``WIDE``."""
    jcfg, jp, tcfg, _ = case(name, 0, WIDE)
    return jcfg, jp, tcfg


def port_model(name):
    """A fresh port model of the family's JAX tree, on the CPU."""
    _, jp, tcfg = jax_case(name)
    return from_jax_params(jp, "cpu", tcfg)


def ids(seed, n=2, S=17):
    """(n, S) token ids: 2 x 17 gives 32 rows per linear."""
    return np.random.default_rng(seed).integers(0, WIDE["vocab_size"],
                                                (n, S)).astype(np.int32)


def adapted(name, seed=3):
    """Both packages' models with the same rank-4 adapters on the family's
    ``TARGETS``, B moved off zero (seeded) so that A takes gradients."""
    _, jparams, _ = jax_case(name)
    jp = jlora.add_lora(jparams, rank=RANK, targets=TARGETS[name],
                        seed=seed)
    model = tlora.add_lora(port_model(name), rank=RANK,
                           targets=TARGETS[name], seed=seed)
    jf = jlora.collect_lora_trainable(jp["layers"], "layers")
    rng = np.random.default_rng(seed + 1)
    newB = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in jf.items() if k.endswith("lora_B")}
    jp["layers"] = jlora.apply_lora_trainable(
        jp["layers"], {**jf, **{k: jnp.asarray(v) for k, v in newB.items()}},
        "layers")
    tlora.apply_lora_trainable(model.layers, newB, "layers")
    return jp, model


def jax_f32_loss(cfg, params, ids):
    """The JAX package's ``causal_lm_loss`` with the compute dtype f32."""
    logits, _ = JR.get_arch(cfg).model_apply(
        cfg, params, ids[:, :-1],
        linear_kw={"training": False, "compute_dtype": jnp.float32})
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, ids[:, 1:, None], -1)[..., 0].mean()


def jax_loss_and_grads(cfg, jp, ids):
    flat = jlora.collect_lora_trainable(jp["layers"], "layers")

    def loss(flat):
        p2 = dict(jp)
        p2["layers"] = jlora.apply_lora_trainable(jp["layers"], flat,
                                                  "layers")
        return jax_f32_loss(cfg, p2, ids)
    val, grads = jax.value_and_grad(loss)(flat)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


def routes(monkeypatch):
    """Record every quantized product from now on, in both packages, as
    (route, q_out, q_in) in call order: "fused" for the fused route's
    entries (the grouped prologue's and ``quant_matmul``'s), "dense" for
    the decoded W of ``quant_matmul``'s dense route."""
    rec = {"jax": [], "port": []}

    def spy(mod, name, pkg, route, qt_arg):
        orig = getattr(mod, name)

        def call(*a, **k):
            qt = a[qt_arg]
            rec[pkg].append((route, int(qt.q_out), int(qt.q_in)))
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, call)
    spy(jdp, "fused_quant_matmul_pre", "jax", "fused", 1)
    spy(jdp, "fused_quant_matmul", "jax", "fused", 1)
    spy(jqm, "decode_weights", "jax", "dense", 0)
    spy(tql, "fused_quant_matmul_pre", "port", "fused", 1)
    spy(tqm, "fused_quant_matmul", "port", "fused", 1)
    spy(tqm, "decode_weights", "port", "dense", 0)
    return rec


def f32_logits(name, jp, model, x):
    """Both packages' logits of ``x`` in f32 compute (JAX's, the port's)."""
    jcfg, _, tcfg = jax_case(name)
    want, _ = JR.get_arch(jcfg).model_apply(
        jcfg, jp, jnp.asarray(x), linear_kw={"compute_dtype": jnp.float32})
    with torch.no_grad():
        got, _ = TR.get_arch(tcfg).model_apply(
            tcfg, model, torch.from_numpy(np.asarray(x)).long(),
            linear_kw={"compute_dtype": torch.float32})
    return got.numpy(), np.asarray(want)


def _epoch_losses(caplog):
    out = []
    for rec in caplog.records:
        m = re.match(r"lora epoch \d+ train ([\d.]+)", rec.getMessage())
        if m:
            out.append(float(m.group(1)))
    return out


def check_train_lora(name, caplog, monkeypatch):
    """``train_lora`` of both packages on the family: adapters on every
    block linear, rank 4, lr 1e-3, 3 epochs of one 2 x 17 batch with the
    validation loss after each, in f32 compute (both packages'
    ``causal_lm_loss`` patched to name it). Per-epoch train losses within
    1e-4 relative, final adapters within 1e-4 absolute (the rule of
    ``tests/test_torch_lora.py``: a tenth of one step at lr 1e-3; Adam's
    first steps are +-lr whatever a gradient's size, so a relative bound
    on B means nothing where a gradient element is near zero)."""
    jcfg, jparams, tcfg = jax_case(name)
    train, valid = ids(7), ids(8)
    caplog.set_level(logging.INFO)
    monkeypatch.setattr(jtrain, "causal_lm_loss", jax_f32_loss)
    loss = ttrain.causal_lm_loss
    monkeypatch.setattr(ttrain, "causal_lm_loss", lambda c, m, x: loss(
        c, m, x, {"compute_dtype": torch.float32}))
    kw = dict(valid_tokens=valid, rank=RANK, lr=1e-3, epochs=3,
              batch_size=2, seed=1, targets=TARGETS[name])
    jp = jtrain.train_lora(jcfg, jparams, train, **kw)
    want_losses = _epoch_losses(caplog)
    caplog.clear()
    model = ttrain.train_lora(tcfg, port_model(name), train, device="cpu",
                              **kw)
    got_losses = _epoch_losses(caplog)
    assert len(got_losses) == len(want_losses) == 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want = jlora.collect_lora_trainable(jp["layers"], "layers")
    got = tlora.collect_lora_trainable(model.layers, "layers")
    assert list(got) == list(want)
    for k, w in want.items():
        err = np.abs(got[k].detach().numpy() - np.asarray(w)).max()
        assert err <= 1e-4, (k, err)
