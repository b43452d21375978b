"""The port's ``QuipQuantizer.quantize_model`` against the JAX package's on
tiny models from the same numpy seeds (``tests/torch_quant_cases.py``):
every linear's codes equal JAX's, or differ only from a near-tie of the
rounding on (the first differing code's JAX top-two score gap under 1e-5
of the score scale, and the linear's proxy loss within 1% of JAX's); the
whole model's f32 logits within 1e-4 of max|logit| plus one f32 ulp of
JAX's quantized model carried across with ``from_jax_params``, linears
accepted at a near-tie taken from JAX's model for that comparison (their
own effect on the logits is printed). Block and end-to-end finetune
losses within 1e-4 relative of JAX's; resume equals an uninterrupted run
bit for bit; the refusals.
"""
import json
import os

import numpy as np
import pytest
import torch

from quip_for_all_tpu.data.calibration import synthetic_tokens
from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.models.config import tiny_config as jtiny

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.models.config import tiny_config
from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
from quip_for_all_tpu_torch.ops.qtensor import to_raw_idxs
from quip_for_all_tpu_torch.quantize.quantizer import (QuipQuantizer,
                                                       model_layers)
from quip_for_all_tpu_torch.utils.convert import from_jax_params

from torch_family_cases import MODEL_TOL, assert_close
from torch_quant_cases import check_linear, run_both

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor ops (an LDLQ loop): one thread a test worker, so
    that a parallel test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T32 = {"compute_dtype": torch.float32}

# name: (arch, config kwargs, quantizer kwargs, calibration rows)
CASES = {
    "llama_head": ("llama", {}, {"quantize_lm_head": True}, 16),
    "llama_merge": ("llama", {"num_key_value_heads": 4},
                    {"merge_suv": True}, 16),
    "mixtral": ("mixtral", {"num_local_experts": 4}, {}, 16),
    "mixtral_merge": ("mixtral", {"num_local_experts": 4},
                      {"merge_suv": True}, 16),
    "qwen_merge": ("qwen", {"num_key_value_heads": 4},
                   {"merge_suv": True}, 16),
    "gpt2": ("gpt2", {"num_key_value_heads": 4,
                      "tie_word_embeddings": True}, {}, 16),
    "llama_finetune": ("llama", {}, {"quantize_lm_head": True,
                                     "ft_epochs": 2, "ft_valid_size": 4},
                       24),
}


def _init(arch, cfg, device=None):
    A = (JR if device is None else TR).get_arch(cfg)
    name = ("init_llama_params" if arch in ("llama", "mixtral", "baichuan")
            else f"init_{arch}_params")
    if device is None:
        return getattr(A, name)(cfg, seed=0)
    return getattr(A, name)(cfg, seed=0, device=device)


def _linears(model):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, QuantLinear)]


def _swap(model, name, mod):
    parent, _, key = name.rpartition(".")
    p = model.get_submodule(parent)
    if isinstance(p, torch.nn.ModuleList):
        p[int(key)] = mod
    elif isinstance(p, torch.nn.ModuleDict):
        p[key] = mod
    else:
        setattr(p, key, mod)


def _logits(cfg, model, ids):
    return TR.get_arch(cfg).model_apply(cfg, model, ids, linear_kw=T32)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_model_matches_jax(case, monkeypatch):
    arch, ckw, qkw, rows = CASES[case]
    cfg, tcfg = jtiny(arch=arch, **ckw), tiny_config(arch=arch, **ckw)
    calib = synthetic_tokens(rows, 32, cfg.vocab_size, seed=1)
    kw = dict(codebook="E8P12", nsamples=8, batch_size=4,
              quip_tune_iters=1, seed=3, **qkw)
    jp, tm, jcalls, tcalls, jq, tq = run_both(
        monkeypatch, cfg, tcfg, _init(arch, cfg), _init(arch, tcfg, "cpu"),
        calib, **kw)
    ref = from_jax_params(jp, "cpu", tcfg)
    jl, tl = _linears(ref), _linears(tm)
    assert [n for n, _ in jl] == [n for n, _ in tl]
    assert len(jcalls) == len(tcalls) == len(tl)
    cb = get_codebook("E8P12")
    accepted = []
    for (name, a), (_, b), jc, tc in zip(jl, tl, jcalls, tcalls):
        same = np.array_equal(to_raw_idxs(a.qweight), to_raw_idxs(b.qweight))
        rec = check_linear(name, jc, tc, cb)
        assert same == (rec is None), name
        if rec is not None:
            accepted.append(rec)
    ids = torch.from_numpy(synthetic_tokens(2, 12, cfg.vocab_size, seed=7)
                           ).long()
    want = _logits(tcfg, ref, ids).numpy()
    if accepted:
        raw = np.abs(_logits(tcfg, tm, ids).numpy() - want).max()
        print(f"{case}: near-tie linears {json.dumps(accepted)}; their "
              f"logit effect {raw / np.abs(want).max():.3g} of max")
        for rec in accepted:
            _swap(tm, rec["linear"], ref.get_submodule(rec["linear"]))
    assert_close(_logits(tcfg, tm, ids).numpy(), want, rel=MODEL_TOL)
    if qkw.get("ft_epochs"):
        for k in ("initial", "best"):
            assert tq.e2e_ft_stats_[k] == pytest.approx(
                jq.e2e_ft_stats_[k], rel=1e-4)
        assert tq.e2e_ft_stats_["best"] <= tq.e2e_ft_stats_["initial"]
    assert len(tq.layer_stats_) == len(tl)
    assert all(0 < s["proxy_loss"] < 1 for s in tq.layer_stats_)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """A run cut after block 1 and resumed from its files makes the model
    of a run never cut, bit for bit (the files keep the generator's
    state too)."""
    cfg = tiny_config(num_hidden_layers=3)
    calib = synthetic_tokens(8, 24, cfg.vocab_size, seed=1)

    def quantizer():
        return QuipQuantizer(codebook="D4", nsamples=8, batch_size=4,
                             quip_tune_iters=0, seed=5)

    def init():
        return TR.get_arch(cfg).init_llama_params(cfg, seed=0, device="cpu")
    full = quantizer().quantize_model(cfg, init(), calib)
    d = str(tmp_path / "state")
    quantizer().quantize_model(cfg, init(), calib, resume_dir=d)
    assert sorted(os.listdir(d)) == ["block_0.pt", "block_1.pt",
                                     "block_2.pt", "resume.json"]
    with open(os.path.join(d, "resume.json"), "w") as f:
        json.dump({"completed": 1}, f)
    resumed = quantizer().quantize_model(cfg, init(), calib, resume_dir=d)
    a, b = full.state_dict(), resumed.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert len(model_layers(resumed)) == 3


def test_refusals():
    # tp_shards and ft_pp are ported (tests/test_torch_tp_quant.py,
    # tests/test_torch_ft_pp.py); ft_pp's pipelined finetune needs a
    # group of ft_pp ranks
    assert QuipQuantizer(codebook="E8P12", tp_shards=2).to_dict()[
        "tp_shards"] == 2
    two = tiny_config()
    with pytest.raises(ValueError, match="world size is 1"):
        QuipQuantizer(codebook="E8P12", ft_pp=2, ft_epochs=1).quantize_model(
            two, TR.get_arch(two).init_llama_params(two, device="cpu"),
            synthetic_tokens(8, 16, two.vocab_size, seed=1))
    with pytest.raises(ValueError, match="sigma_reg"):
        QuipQuantizer(codebook="E8P12", sigma_reg=1.5)
    with pytest.raises(ValueError, match="Invalid codebook"):
        QuipQuantizer(codebook="E9")
    gcfg = tiny_config(arch="gpt2", num_key_value_heads=4,
                       tie_word_embeddings=True)
    calib = synthetic_tokens(4, 16, gcfg.vocab_size, seed=1)
    model = TR.get_arch(gcfg).init_gpt2_params(gcfg, device="cpu")
    with pytest.raises(ValueError, match="merge_suv not supported"):
        QuipQuantizer(codebook="E8P12", merge_suv=True).quantize_model(
            gcfg, model, calib)
    with pytest.raises(ValueError, match="incompatible with merge_suv"):
        QuipQuantizer(codebook="E8P12", merge_suv=True,
                      ft_epochs=1).quantize_model(gcfg, model, calib)


def test_config_schema_equals_jax():
    from quip_for_all_tpu.quantize.quantizer import QuipQuantizer as JQ
    for kw in ({"codebook": "E8P12"},
               {"codebook": "E8P12RVQ3B", "opt_resid_scale": 0.5,
                "per_channel": True, "modules_to_not_convert": ["lm_head"]},
               {"codebook": "HI", "merge_suv": True, "use_rand": False}):
        d = QuipQuantizer(**kw).to_dict()
        assert d == JQ(**kw).to_dict()
        assert QuipQuantizer.from_dict(dict(d, codebook=kw["codebook"])
                                       ).to_dict() == d
