"""LoRA on the other families (``nn/lora.py`` ``add_lora``,
``quantize/lora_train.py`` ``causal_lm_loss``) against the JAX package on
each family's random E8P12 model (``tests/torch_lora_cases.py``): the
adapters ``add_lora`` makes (the same keys in the same order, A drawn
bitwise), zero-init adapters leaving the logits as they were, the
defaults' match on each family, and the f32 loss and adapter gradients of
one step with the route of every quantized product.

Tolerances (f32 compute; the transforms and products sum in other
orders): the loss within 1e-5 of JAX's (relative), each adapter gradient
within 1e-4 of the tensor's max, the rule of ``tests/test_torch_lora.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.quantize import lora_train as jtrain

from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.nn import lora as tlora
from quip_for_all_tpu_torch.nn.lora import LoraLinear
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.quantize import lora_train as ttrain

from torch_lora_cases import (DEFAULTS_MATCH_NOTHING, PER_BLOCK, RANK,
                              TARGETS, WIDE, adapted, ids, jax_case,
                              jax_loss_and_grads, port_model, routes)

pytestmark = pytest.mark.fast

NAMES = list(TARGETS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_add_lora_draws_jax_adapters_key_for_key(name):
    _, jparams, tcfg = jax_case(name)
    jf = jlora.collect_lora_trainable(
        jlora.add_lora(jparams, rank=8, alpha=16.0, targets=TARGETS[name],
                       seed=11)["layers"], "layers")
    model = tlora.add_lora(port_model(name), rank=8, alpha=16.0,
                           targets=TARGETS[name], seed=11)
    tf = tlora.collect_lora_trainable(model.layers, "layers")
    assert list(tf) == list(jf)
    assert len(tf) == 2 * PER_BLOCK[name] * WIDE["num_hidden_layers"]
    for k, v in jf.items():
        assert np.array_equal(tf[k].detach().numpy(), np.asarray(v)), k
        assert tf[k].requires_grad
    # everything outside the adapters is frozen, the biases too
    assert {n for n, p in model.named_parameters() if p.requires_grad} == \
        set(tf)
    # fusion leaves LoRA-wrapped linears unfused (QWen's w1/w2 stay apart)
    fused = TR.fuse_for_inference(tcfg, model)
    for k in tf:
        lin = k.rsplit(".", 1)[0].replace("layers.", "", 1).split(".")
        node = fused.layers[int(lin[0])]
        for part in lin[1:]:
            node = node[part]
        assert isinstance(node, LoraLinear), k


@pytest.mark.parametrize("name", NAMES)
def test_default_targets_wrap_what_jax_wraps(name):
    """The llama defaults: the same keys as JAX's where they match (OPT,
    Phi and GPT-J's q/k/v, Baichuan's o and MLP), and JAX's ValueError
    from ``train_lora`` where they match nothing."""
    jcfg, jparams, tcfg = jax_case(name)
    jf = jlora.collect_lora_trainable(jlora.add_lora(jparams)["layers"],
                                      "layers")
    tf = tlora.collect_lora_trainable(tlora.add_lora(
        port_model(name)).layers, "layers")
    assert list(tf) == list(jf)
    assert (not tf) == (name in DEFAULTS_MATCH_NOTHING)
    if tf:
        return
    toks = ids(1)
    with pytest.raises(ValueError, match="no linear matched LoRA targets"):
        jtrain.train_lora(jcfg, jparams, toks, epochs=1, batch_size=2)
    with pytest.raises(ValueError, match="no linear matched LoRA targets"):
        ttrain.train_lora(tcfg, port_model(name), toks, epochs=1,
                          batch_size=2, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_zero_init_adapters_leave_the_logits_unchanged(name):
    _, _, tcfg = jax_case(name)
    model = port_model(name)
    x = torch.from_numpy(ids(2)).long()
    apply = TR.get_arch(tcfg).model_apply
    with torch.no_grad():
        l0, _ = apply(tcfg, model, x)
        tlora.add_lora(model, rank=RANK, targets=TARGETS[name])
        l1, _ = apply(tcfg, model, x)
    assert torch.equal(l0, l1)


@pytest.mark.parametrize("name", NAMES)
def test_loss_grads_and_routes_match_jax(name, monkeypatch):
    """One f32 step: the loss, every adapter gradient, and the route of
    every quantized product of the forward in call order (the fused route
    wherever q_out % 128 == 0, so everywhere but Falcon's one-KV-head qkv);
    K3's twin runs once for each fused linear whose input needs a
    gradient: all but layer 0's linears that read the embedding's norm."""
    jcfg, _, tcfg = jax_case(name)
    jp, model = adapted(name)
    x = ids(5)
    rec = routes(monkeypatch)
    want_loss, want = jax_loss_and_grads(jcfg, jp, jnp.asarray(x))
    bwd = []
    twin = tfm.fused_decode_matmul_bwd_ref
    monkeypatch.setattr(tfm, "fused_decode_matmul_bwd_ref",
                        lambda *a, **k: bwd.append(1) or twin(*a, **k))
    loss = ttrain.causal_lm_loss(tcfg, model, torch.from_numpy(x),
                                 {"compute_dtype": torch.float32})
    fwd = list(rec["port"])
    loss.backward()
    assert fwd == rec["jax"]
    fused = [r for r in fwd if r[0] == "fused"]
    assert len(fused) == len(fwd) - (2 if name == "falcon" else 0)
    assert 0 < len(bwd) < len(fused)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    got = tlora.collect_lora_trainable(model.layers, "layers")
    assert sorted(got) == sorted(want)      # jax.grad sorts dict keys
    for k, w in want.items():
        assert np.abs(w).max() > 0, k
        err = np.abs(got[k].grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err)
