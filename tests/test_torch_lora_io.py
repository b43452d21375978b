"""The LoRA slice's files and data against the JAX package: adapter files
(the native and the PEFT layout) written by either package and read by the
other with bit-equal arrays, the port's safetensors writer read by the
``safetensors`` package, ``synthetic_tokens`` draw for draw, and the port's
fine-tuning CLI on the CPU over a checkpoint the JAX package quantized and
saved."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from quip_for_all_tpu.data import calibration as jcal
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.quantize import lora_train as jtrain
from quip_for_all_tpu.quantize.quantizer import QuipQuantizer
from quip_for_all_tpu.utils import checkpoint as jckpt
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.cli import finetune_lora as cli
from quip_for_all_tpu_torch.data import calibration as tcal
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import lora as tlora
from quip_for_all_tpu_torch.quantize import lora_train as ttrain
from quip_for_all_tpu_torch.utils.convert import from_jax_params
from quip_for_all_tpu_torch.utils.safetensors_io import load_file, save_file

pytestmark = pytest.mark.fast

DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=128)


@pytest.fixture(scope="module")
def jparams():
    return random_quantized_model(JConfig(**DIMS), "E8P12", seed=0,
                                  dtype=jnp.float32, quantize_head=True)


def _trained_jax(jparams, seed=2):
    """JAX adapters with B moved off zero (as if trained)."""
    jp = jlora.add_lora(jparams, rank=4, alpha=8.0, seed=seed)
    flat = jlora.collect_lora_trainable(jp["layers"], "layers")
    rng = np.random.default_rng(seed)
    flat = {k: v + (rng.standard_normal(v.shape).astype(np.float32) * 0.05
                    if k.endswith("lora_B") else 0.0)
            for k, v in flat.items()}
    jp["layers"] = jlora.apply_lora_trainable(jp["layers"], flat, "layers")
    return jp, {k: np.asarray(v) for k, v in flat.items()}


def _port_flat(model):
    return {k: v.detach().numpy() for k, v in
            tlora.collect_lora_trainable(model.layers, "layers").items()}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", ["native", "peft"])
def test_adapter_files_cross_between_the_packages(jparams, layout,
                                                  tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads; and the port
    reads back what it wrote: the same f32 arrays, bit for bit."""
    jp, want = _trained_jax(jparams)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if layout == "native":
        jtrain.save_lora(jp, jdir, rank=4, alpha=8.0)
        model = ttrain.load_lora(from_jax_params(jparams, "cpu"), jdir,
                                 device="cpu")
        ttrain.save_lora(model, tdir, rank=4, alpha=8.0)
        back = jtrain.load_lora(jparams, tdir)
        again = ttrain.load_lora(from_jax_params(jparams, "cpu"), tdir,
                                 device="cpu")
        names = (ttrain.ADAPTER_FILE, ttrain.ADAPTER_CONFIG)
    else:
        jtrain.export_peft(jp, jdir, rank=4, alpha=8.0)
        model = ttrain.import_peft(from_jax_params(jparams, "cpu"), jdir,
                                   device="cpu")
        ttrain.export_peft(model, tdir, rank=4, alpha=8.0)
        back = jtrain.import_peft(jparams, tdir)
        again = ttrain.import_peft(from_jax_params(jparams, "cpu"), tdir,
                                   device="cpu")
        names = (ttrain.PEFT_ADAPTER_FILE, ttrain.PEFT_ADAPTER_CONFIG)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == \
        sorted(names)
    with open(os.path.join(jdir, names[1])) as f, \
            open(os.path.join(tdir, names[1])) as g:
        assert json.load(f) == json.load(g)
    assert float(model.layers[0]["mlp"]["up_proj"].lora_scale) == 2.0
    _assert_same(_port_flat(model), want)
    _assert_same(_port_flat(again), want)
    _assert_same({k: np.asarray(v) for k, v in jlora.collect_lora_trainable(
        back["layers"], "layers").items()}, want)
    # the tensors' names in the file are the JAX package's, byte for byte
    assert sorted(st_load(os.path.join(tdir, names[0]))) == \
        sorted(st_load(os.path.join(jdir, names[0])))


def test_loaded_adapters_give_jax_logits(jparams, tmp_path):
    jp, _ = _trained_jax(jparams)
    jtrain.save_lora(jp, str(tmp_path), rank=4, alpha=8.0)
    model = ttrain.load_lora(from_jax_params(jparams, "cpu"), str(tmp_path),
                             device="cpu")
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    want, _ = JM.model_apply(JConfig(**DIMS), jp, jnp.asarray(ids),
                             linear_kw={"compute_dtype": jnp.float32})
    with torch.no_grad():
        got, _ = TM.model_apply(ModelConfig(**DIMS), model,
                                torch.from_numpy(ids),
                                linear_kw={"compute_dtype": torch.float32})
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_load_refuses_a_file_missing_adapters(jparams, tmp_path):
    model = tlora.add_lora(from_jax_params(jparams, "cpu"), rank=4)
    ttrain.save_lora(model, str(tmp_path), rank=4, alpha=8.0,
                     targets=("q_proj",))
    # the config names every default target; the file holds q_proj only
    with open(tmp_path / ttrain.ADAPTER_CONFIG, "w") as f:
        json.dump({"rank": 4, "alpha": 8.0,
                   "targets": list(tlora.DEFAULT_TARGETS)}, f)
    save_file({k: v for k, v in _port_flat(model).items()
               if ".q_proj." in k}, str(tmp_path / ttrain.ADAPTER_FILE))
    with pytest.raises(ValueError, match="missing keys"):
        ttrain.load_lora(from_jax_params(jparams, "cpu"), str(tmp_path),
                         device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32,
                                   np.int64, np.uint8, np.bool_])
def test_save_file_is_read_by_safetensors_and_back(dtype, tmp_path):
    rng = np.random.default_rng(0)
    t = {"b.weight": (rng.standard_normal((3, 5)) * 10).astype(dtype),
         "a": (rng.standard_normal((7,)) * 10).astype(dtype),
         "empty": np.zeros((0, 2), dtype)}
    save_file(t, str(tmp_path / "port.safetensors"))
    _assert_same(st_load(str(tmp_path / "port.safetensors")), t)
    st_save(t, str(tmp_path / "lib.safetensors"))
    _assert_same(load_file(str(tmp_path / "lib.safetensors")), t)
    _assert_same(load_file(str(tmp_path / "port.safetensors")), t)


@pytest.mark.parametrize("n,S,V,seed", [(2, 17, 256, 0), (3, 40, 32000, 7),
                                        (5, 9, 50, 3)])
def test_synthetic_tokens_equal_jax(n, S, V, seed):
    want = jcal.synthetic_tokens(n, S, V, seed)
    got = tcal.synthetic_tokens(n, S, V, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(
        tcal.get_calibration_tokens("synthetic", None, n, S, seed,
                                    vocab_size=V), want)


class _CharTokenizer:
    def __call__(self, text):
        class Out:
            input_ids = [ord(c) % 256 for c in text]
        return Out()


@pytest.mark.parametrize("kind", ["txt", "jsonl"])
def test_file_corpus_windows_equal_jax(kind, tmp_path):
    tok = _CharTokenizer()
    if kind == "txt":
        p = tmp_path / "corpus.txt"
        p.write_text("the quick brown fox jumps over the lazy dog. " * 20)
    else:
        p = tmp_path / "docs.jsonl"
        p.write_text("\n".join(json.dumps({"body": "doc %d " % i * (i + 3)})
                               for i in range(12)))
        p = f"{p}#body"
    spec = f"file:{p}"
    want = jcal.get_calibration_tokens(spec, tok, 4, 16, seed=5)
    got = tcal.get_calibration_tokens(spec, tok, 4, 16, seed=5)
    assert np.array_equal(got, want)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tcal.get_calibration_tokens("wikitext2", tok, 4, 16)


@pytest.fixture(scope="module")
def saved_llama(tmp_path_factory):
    """A tiny llama quantized (E8P12) and saved by the JAX package."""
    jcfg = JConfig(**{**DIMS, "num_hidden_layers": 1})
    q = QuipQuantizer(codebook="E8P12", nsamples=8, batch_size=4,
                      quip_tune_iters=0, ft_epochs=0)
    qparams = q.quantize_model(jcfg, JM.init_llama_params(jcfg, seed=0),
                               jcal.synthetic_tokens(8, 24, 256, seed=1))
    d = str(tmp_path_factory.mktemp("llama") / "ckpt")
    jckpt.save_quantized(jcfg, qparams, q.to_dict(), d)
    return d


def test_cli_finetunes_on_the_cpu(saved_llama, tmp_path):
    out = str(tmp_path / "lora")
    cli.main(["--model-path", saved_llama, "--save-dir", out,
              "--dataset", "synthetic", "--nsamples", "4",
              "--valid-samples", "2", "--seqlen", "17", "--rank", "2",
              "--epochs", "1", "--batch-size", "2", "--device", "cpu"])
    assert sorted(os.listdir(out)) == sorted(
        [ttrain.ADAPTER_FILE, ttrain.ADAPTER_CONFIG,
         ttrain.PEFT_ADAPTER_FILE, ttrain.PEFT_ADAPTER_CONFIG])
    # the JAX package attaches the port's adapters to its own load
    _, jp, _ = jckpt.load_quantized(saved_llama)
    flat = jlora.collect_lora_trainable(
        jtrain.load_lora(jp, out)["layers"], "layers")
    assert len(flat) == 14
    assert any(np.abs(np.asarray(v)).max() > 0 for k, v in flat.items()
               if k.endswith("lora_B"))
    no_peft = str(tmp_path / "native")
    cli.main(["--model-path", saved_llama, "--save-dir", no_peft,
              "--nsamples", "2", "--valid-samples", "0", "--seqlen", "9",
              "--epochs", "1", "--batch-size", "2", "--device", "cpu",
              "--no-peft", "--targets", "o_proj"])
    assert sorted(os.listdir(no_peft)) == sorted(
        [ttrain.ADAPTER_FILE, ttrain.ADAPTER_CONFIG])
