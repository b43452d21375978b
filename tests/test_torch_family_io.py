"""The eight other families through the port's checkpoint loader, serving
engine, fusion and random models:

- each family's random quantized tree (``tests/torch_family_cases.py``)
  written by the JAX package's ``save_quantized`` into ``tmp_path`` and
  read back by both packages' ``load_quantized``: the port's logits held
  to the JAX-loaded model's; also Yi's ln1/ln2 norm names on a llama
  checkpoint and QWen with its head tied (no ``lm_head`` in the file);
- a GPT-NeoX ``ServingEngine`` held to the JAX engine (greedy, f32
  activations, ids equal or forked at bf16 ties only);
- QWen's ``fuse_for_inference`` (w1/w2 into one launch) held to the
  unfused model and to JAX's fused one;
- the port's ``random_quantized_model`` for every family (shared group
  transforms, biases where the family has them, the head rule); LoRA on
  the families is held to JAX in ``tests/test_torch_lora_families*.py``.

Tolerance of logits: 1e-4 of max|logit| plus one f32 ulp in f32 compute
(``torch_family_cases.MODEL_TOL`` says why).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.models import qwen as JQ
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.runtime.serving import ServingEngine as JEngine
from quip_for_all_tpu.utils import checkpoint as jckpt

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.models.tree import FamilyModel
from quip_for_all_tpu_torch.nn.qlinear import FusedQuantLinear, QuantLinear
from quip_for_all_tpu_torch.quantize.quantizer import sublayer_groups
from quip_for_all_tpu_torch.runtime.serving import ServingEngine
from quip_for_all_tpu_torch.utils.checkpoint import load_quantized
from quip_for_all_tpu_torch.utils.safetensors_io import load_file, save_file

from torch_family_cases import (BASE, F32, FAMILIES, MODEL_TOL, T32, _init,
                                assert_close, assert_ids_agree, case, configs,
                                quantized_tree)

pytestmark = pytest.mark.fast

QCFG = {"quant_method": "QUiP", "codebook": "E8P12", "use_rand": True,
        "per_channel": False, "opt_resid_scale": -1, "tp_shards": 1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits_agree(d):
    """Both packages' load_quantized of ``d``: the same config and f32
    logits within the model tolerance."""
    jcfg, jp, _ = jckpt.load_quantized(d)
    tcfg, port, _ = load_quantized(d, device="cpu")
    assert tcfg == ModelConfig(**{f: getattr(jcfg, f)
                                  for f in jcfg.__dataclass_fields__})
    ids = np.random.default_rng(7).integers(0, 256, (2, 10))
    want, _ = JR.get_arch(jcfg).model_apply(jcfg, jp, jnp.asarray(ids),
                                            linear_kw=F32)
    got, _ = TR.get_arch(tcfg).model_apply(tcfg, port, torch.from_numpy(ids),
                                           linear_kw=T32)
    assert_close(got.numpy(), np.asarray(want), MODEL_TOL)
    return tcfg, port


@pytest.mark.parametrize("name", list(FAMILIES))
def test_load_quantized_matches_jax(name, tmp_path):
    jcfg, _ = configs(name)
    d = str(tmp_path / name)
    jckpt.save_quantized(jcfg, quantized_tree(jcfg), QCFG, d)
    tcfg, port = _logits_agree(d)
    assert type(port).__name__ == ("LlamaModel" if name == "baichuan"
                                   else "FamilyModel")
    if name == "baichuan":
        assert isinstance(port.layers[0]["self_attn"]["W_pack"], QuantLinear)


def test_yi_norm_aliases_load(tmp_path):
    """A llama checkpoint whose block norms are named ln1/ln2 (Yi)."""
    jcfg = JConfig(**dict(BASE, num_key_value_heads=2))
    d = str(tmp_path / "yi")
    jckpt.save_quantized(jcfg, quantized_tree(jcfg), QCFG, d)
    path = os.path.join(d, "model.safetensors")
    t = load_file(path)
    save_file({k.replace(".input_layernorm.", ".ln1.").replace(
        ".post_attention_layernorm.", ".ln2."): v for k, v in t.items()},
        path)
    assert any(".ln1." in k for k in load_file(path))
    _logits_agree(d)


def test_qwen_tied_head_loads(tmp_path):
    """QWen without an ``lm_head``: both loaders tie the head to wte."""
    jcfg = JConfig(**dict(BASE, **FAMILIES["qwen"],
                          tie_word_embeddings=True))
    d = str(tmp_path / "qwen_tied")
    jckpt.save_quantized(jcfg, quantized_tree(jcfg), QCFG, d)
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)["tie_word_embeddings"] is True
    assert not any(k.startswith("lm_head") for k in load_file(
        os.path.join(d, "model.safetensors")))
    _, port = _logits_agree(d)
    assert "lm_head" not in port


def test_gpt_neox_serving_matches_jax():
    """Three requests at two slots (one admitted while the others decode,
    a prompt longer than the prefill chunk), greedy in f32 activations:
    the on_token streams emit the same (request, done) sequence as the JAX
    engine's, each request's tokens its ids, and every request's ids equal
    JAX's or fork at bf16 ties only (``assert_ids_agree``)."""
    jcfg, jp, tcfg, port = case("gpt_neox")
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 256, n), m) for n, m in ((5, 6), (11, 4),
                                                      (3, 5))]
    kw = dict(max_batch=2, cache_len=64, prefill_chunk=8, decode_chunk=4)
    outs = []
    for make in (lambda cb: JEngine(jcfg, jp, dtype=jnp.float32,
                                    on_token=cb, **kw),
                 lambda cb: ServingEngine(tcfg, port, dtype=torch.float32,
                                          on_token=cb, device="cpu", **kw)):
        events = []
        eng = make(lambda rid, tok, done: events.append(
            (rid, int(tok), bool(done))))
        rids = [eng.add_request(p, m) for p, m in reqs]
        res = eng.run(max_steps=500)
        outs.append(([np.asarray(res[r]).astype(np.int64) for r in rids],
                     events))
    (jids, jev), (tids, tev) = outs
    assert [(r, d) for r, _, d in tev] == [(r, d) for r, _, d in jev]
    for r, ((p, m), a, b) in enumerate(zip(reqs, tids, jids)):
        assert a.shape == (len(p) + m,)
        assert [t for q, t, _ in tev if q == r] == list(a[len(p):])
        assert_ids_agree(jcfg, jp, len(p), a, b)


def test_qwen_fuse_for_inference():
    """w1/w2 fuse into one ``w12_proj`` launch; the fused model's logits
    equal the unfused one's and JAX's fused model's."""
    jcfg, jp, tcfg, port = case("qwen")
    fused = qt.fuse_for_inference(tcfg, port)
    mlp = fused["layers"][0]["mlp"]
    assert sorted(mlp.keys()) == ["c_proj", "w12_proj"]
    assert isinstance(mlp["w12_proj"], FusedQuantLinear)
    assert sorted(port["layers"][0]["mlp"].keys()) == ["c_proj", "w1", "w2"]
    ids = np.random.default_rng(9).integers(0, 256, (2, 10))
    ref, _ = TR.get_arch(tcfg).model_apply(tcfg, port, torch.from_numpy(ids),
                                           linear_kw=T32)
    got, _ = TR.get_arch(tcfg).model_apply(tcfg, fused, torch.from_numpy(ids),
                                           linear_kw=T32)
    assert_close(got.numpy(), ref.numpy(), MODEL_TOL)
    want, _ = JQ.model_apply(jcfg, JQ.fuse_for_inference(jcfg, jp),
                             jnp.asarray(ids), linear_kw=F32)
    assert_close(got.numpy(), np.asarray(want), MODEL_TOL)


# widths random_quantized_model's planes take (q_in a multiple of 8, every
# hadK factor orthogonal): both routes of the shape rule still occur
RANDOM = dict(BASE, hidden_size=128, intermediate_size=192)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_random_model_follows_the_groups(name):
    cfg = ModelConfig(**dict(RANDOM, **FAMILIES[name]))
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.float32,
                                      quantize_head=True, device="cpu")
    if cfg.arch == "baichuan":
        tree = {"layers": [dict(b.items()) for b in model.layers]}
        head = model.lm_head
    else:
        assert isinstance(model, FamilyModel)
        tree = model
        key = TR.untied_head_key(cfg, model)
        head = None if key is None else model[key]
    # the JAX init_*_params tree at the same widths: shapes and biases
    jtree = _init(JConfig(**dict(RANDOM, **FAMILIES[name])), 0)
    for blk, jblk in zip(tree["layers"], jtree["layers"]):
        for g in sublayer_groups(cfg):
            lins = []
            for path in g["layers"]:
                node, want = blk, jblk
                for part in path.split("."):
                    node, want = node[part], want[part]
                assert isinstance(node, QuantLinear)
                assert (node.out_features, node.in_features) == tuple(
                    want["weight"].shape)
                assert (node.bias is not None) == (want["bias"] is not None)
                lins.append(node)
            assert all(p.SU is lins[0].SU and p.had_left is lins[0].had_left
                       for p in lins)
    untied = not cfg.tie_word_embeddings
    assert (head is not None) == untied
    if untied:
        assert isinstance(head, QuantLinear)        # V = 256
    ids = torch.arange(6)[None]
    out = qt.generate(cfg, qt.fuse_for_inference(cfg, model), ids, 4,
                      cache_len=32, dtype=torch.float32, device="cpu")
    assert out.shape == (1, 10)


def test_random_model_head_rule():
    """An untied head is quantized only when asked and the vocabulary is a
    multiple of 128, else dense (with the family's bias)."""
    for vocab, ask, quantized in ((256, True, True), (256, False, False),
                                  (200, True, False)):
        cfg = ModelConfig(**dict(RANDOM, **FAMILIES["phi"],
                                 vocab_size=vocab))
        m = qt.random_quantized_model(cfg, seed=0, dtype=torch.float32,
                                      quantize_head=ask, device="cpu")
        head = m["lm_head"]
        assert isinstance(head, QuantLinear) == quantized
        assert head.bias is not None and head.bias.shape == (vocab,)
