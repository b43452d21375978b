"""LoRA on the other families beyond the step (``tests/torch_lora_cases.py``;
``generate`` with adapters: ``tests/test_torch_lora_families_generate.py``):
adapter files
(``save_lora`` and ``export_peft``) written by either package and read by
the other, bit-equal, and the loaded adapters giving JAX's logits; a
family checkpoint loaded by both packages drawing the same adapters; and
the fine-tuning CLI on a GPT-NeoX checkpoint with ``--targets``.

Tolerance: f32 logits within ``torch_family_cases.MODEL_TOL`` (1e-4 of
max|logit| plus one ulp; it says why).
"""
import json
import os

import numpy as np
import pytest
import torch

from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.quantize import lora_train as jtrain
from quip_for_all_tpu.utils import checkpoint as jckpt

from quip_for_all_tpu_torch.cli import finetune_lora as cli
from quip_for_all_tpu_torch.models.tree import FamilyModel
from quip_for_all_tpu_torch.nn import lora as tlora
from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
from quip_for_all_tpu_torch.quantize import lora_train as ttrain
from quip_for_all_tpu_torch.utils.checkpoint import load_quantized

from torch_family_cases import MODEL_TOL, assert_close
from torch_lora_cases import (RANK, TARGETS, adapted, f32_logits, ids,
                              jax_case, port_model)

pytestmark = pytest.mark.fast

NAMES = list(TARGETS)
QCFG = {"quant_method": "QUiP", "codebook": "E8P12", "use_rand": True,
        "per_channel": False, "opt_resid_scale": -1, "tp_shards": 1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree_layers, port):
    get = tlora.collect_lora_trainable if port else \
        jlora.collect_lora_trainable
    return {k: (v.detach().numpy() if port else np.asarray(v))
            for k, v in get(tree_layers, "layers").items()}


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", ["native", "peft"])
@pytest.mark.parametrize("name", NAMES)
def test_adapter_files_cross_between_the_packages(name, layout, tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads: the same
    f32 arrays bit for bit under the same keys (the PEFT prefix
    ``base_model.model.model.`` for every family, as the JAX package
    writes it), and the port's loaded adapters give JAX's logits (once,
    on the PEFT layout: the native layout loads the same arrays)."""
    _, jparams, _ = jax_case(name)
    jp, _ = adapted(name)
    want = _flat(jp["layers"], False)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if layout == "native":
        jtrain.save_lora(jp, jdir, rank=RANK, alpha=16.0,
                         targets=TARGETS[name])
        model = ttrain.load_lora(port_model(name), jdir, device="cpu")
        ttrain.save_lora(model, tdir, rank=RANK, alpha=16.0,
                         targets=TARGETS[name])
        back = jtrain.load_lora(jparams, tdir)
    else:
        jtrain.export_peft(jp, jdir, rank=RANK, alpha=16.0,
                           targets=TARGETS[name])
        model = ttrain.import_peft(port_model(name), jdir, device="cpu")
        ttrain.export_peft(model, tdir, rank=RANK, alpha=16.0,
                           targets=TARGETS[name])
        back = jtrain.import_peft(jparams, tdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for f in os.listdir(jdir):
        if f.endswith(".json"):
            with open(os.path.join(jdir, f)) as a, \
                    open(os.path.join(tdir, f)) as b:
                assert json.load(a) == json.load(b)
    _assert_same(_flat(model.layers, True), want)
    _assert_same(_flat(back["layers"], False), want)
    if layout == "peft":
        got, ref = f32_logits(name, jp, model, ids(1, S=12))
        assert_close(got, ref, MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_loaded_checkpoint_draws_jax_adapters(name, tmp_path):
    """A checkpoint the JAX package saved, loaded by both packages: the
    port's model comes back unfused (each target a ``QuantLinear`` under
    its adapter, trainable as loaded), and ``add_lora`` draws JAX's
    adapters on it key for key."""
    jcfg, jparams, _ = jax_case(name)
    d = str(tmp_path / name)
    jckpt.save_quantized(jcfg, jparams, QCFG, d)
    _, jp, _ = jckpt.load_quantized(d)
    _, model, _ = load_quantized(d, device="cpu")
    jf = _flat(jlora.add_lora(jp, rank=RANK, targets=TARGETS[name],
                              seed=5)["layers"], False)
    tlora.add_lora(model, rank=RANK, targets=TARGETS[name], seed=5)
    _assert_same(_flat(model.layers, True), jf)
    assert all(isinstance(m.lora_base, QuantLinear) for m in model.modules()
               if isinstance(m, tlora.LoraLinear))
    assert isinstance(model, FamilyModel) == (name != "baichuan")


def test_cli_finetunes_a_family_on_the_cpu(tmp_path):
    """``cli.finetune_lora --targets`` on a GPT-NeoX checkpoint the JAX
    package saved: both layouts written, ``load_lora`` and ``import_peft``
    giving the same logits, and the JAX package reading the adapters onto
    its own load of the checkpoint with the same logits."""
    name = "gpt_neox"
    jcfg, jparams, _ = jax_case(name)
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "lora")
    jckpt.save_quantized(jcfg, jparams, QCFG, ckpt)
    cli.main(["--model-path", ckpt, "--save-dir", out,
              "--dataset", "synthetic", "--nsamples", "4",
              "--valid-samples", "0", "--seqlen", "17", "--rank", "2",
              "--epochs", "1", "--batch-size", "2", "--lr", "1e-3",
              "--device", "cpu", "--targets", *TARGETS[name]])
    assert sorted(os.listdir(out)) == sorted(
        [ttrain.ADAPTER_FILE, ttrain.ADAPTER_CONFIG,
         ttrain.PEFT_ADAPTER_FILE, ttrain.PEFT_ADAPTER_CONFIG])
    tcfg, base, _ = load_quantized(ckpt, device="cpu")
    native = ttrain.load_lora(base, out, device="cpu")
    peft = ttrain.import_peft(load_quantized(ckpt, device="cpu")[1], out,
                              device="cpu")
    flat = _flat(native.layers, True)
    assert len(flat) == 2 * 4 * jcfg.num_hidden_layers
    assert any(np.abs(v).max() > 0 for k, v in flat.items()
               if k.endswith("lora_B"))
    _, jp, _ = jckpt.load_quantized(ckpt)
    jp = jtrain.load_lora(jp, out)
    x = ids(2, S=12)
    a, want = f32_logits(name, jp, native, x)
    b, _ = f32_logits(name, jp, peft, x)
    assert np.array_equal(a, b)
    assert_close(a, want, MODEL_TOL)
