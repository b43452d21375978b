"""The pipelined end-to-end finetune (``QuipQuantizer(ft_pp=)``,
``cli/quantize.py --ft-pp``) and sequence-parallel perplexity from the
command line (``cli/eval_ppl.py --sp``) on two gloo ranks on the CPU,
held to the JAX package's runs on its 8-device CPU mesh.

Two ranks are spawned once for the file (``tests/torch_tp_cases.py``);
each runs the port's ``quantize_model`` (or CLI) whole, as a group of
``ft_pp`` processes does, and rank 0 saves. The JAX package's CLI runs
once for the file (``jax_run``: its pipelined finetune compiles for ~16
s on the CPU), and both the port's ``QuipQuantizer`` and its CLI are
held to that run. The quantizer's codes equal JAX's, or differ first at
a near-tie of the rounding (``tests/torch_quant_cases.py``); the finetune's initial and best
validation losses are within 1e-4 (relative) of JAX's; the saved
directories hold the same files and tensors: codes and untrained tensors
byte for byte (Wscale within 1e-6, its sum order), the finetuned vectors
(SU, SV, norms) within ``_ft_bound`` and on average within 1e-6.
"""
import json
import os

import numpy as np
import pytest
import torch

from quip_for_all_tpu.cli import eval_ppl as j_eval_ppl
from quip_for_all_tpu.cli import quantize as j_quantize
from quip_for_all_tpu.data.calibration import synthetic_tokens
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import tiny_config as jtiny
import quip_for_all_tpu.quantize.quantizer as JQQ

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.models.config import tiny_config
from quip_for_all_tpu_torch.models.llama import init_llama_params
from quip_for_all_tpu_torch.quantize.quantizer import QuipQuantizer
from quip_for_all_tpu_torch.utils.safetensors_io import load_file

import torch_tp_cases as C
from torch_quant_cases import check_linear

pytestmark = pytest.mark.fast

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "e8p12")


def _ft_bound(key: str, steps: int) -> float:
    """How far apart ``steps`` Adam steps can move one finetuned value in
    the two packages: a step moves it by about its learning rate whatever
    the gradient's size, so a gradient component near zero whose sign the
    two sum orders flip parts them by up to 2 lr a step (QuipQuantizer's
    ft_susv_lr for SU and SV, ft_lr for the rest)."""
    lr = 5e-4 if key.endswith((".SU", ".SV")) else 5e-5
    return 2 * lr * steps


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(2)
    yield r
    r.close()


def _finetuned(key: str) -> bool:
    return key.endswith((".SU", ".SV")) or "norm" in key


def _same_dirs(a, b, steps, skip=()):
    """The files of save directories ``a`` (JAX) and ``b`` (port), after
    ``steps`` finetune steps: equal JSON; per tensor equal bytes, Wscale
    within 1e-6, the finetuned vectors within ``_ft_bound`` and on average
    within 1e-6; the tensors of the linears in ``skip`` (codes accepted at
    a near-tie) only alike in shape."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for fn in sorted(os.listdir(a)):
        pa, pb = os.path.join(a, fn), os.path.join(b, fn)
        if fn.endswith(".json"):
            with open(pa) as f, open(pb) as g:
                assert json.load(f) == json.load(g), fn
            continue
        ta, tb = load_file(pa), load_file(pb)
        assert sorted(ta) == sorted(tb), fn
        for k in ta:
            assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape
            if any(k.startswith(s + ".") for s in skip):
                continue
            if k.endswith(".Wscale"):
                np.testing.assert_allclose(tb[k], ta[k], rtol=1e-6, atol=0)
            elif _finetuned(k):
                d = np.abs(tb[k].astype(np.float32) - ta[k].astype(np.float32))
                assert d.max() <= _ft_bound(k, steps), (k, d.max())
                assert d.mean() <= 1e-6, (k, d.mean())
            else:
                assert ta[k].tobytes() == tb[k].tobytes(), k


CLI_ARGS = ["--model-path", "random:tiny", "--codebook", "D4",
            "--nsamples", "8", "--seqlen", "32", "--batch-size", "8",
            "--quip-tune-iters", "1", "--seed", "1", "--ft-epochs", "1",
            "--ft-train-size", "16", "--ft-valid-size", "8", "--ft-pp", "2"]
# the QuipQuantizer that both CLIs build from CLI_ARGS (its finetune in 8
# microbatches: the CLIs' ft_batch_size, which the port's API takes as
# ft_microbatches here), on tiny_config()'s 2 layers, init seed 1, and
# 8 + 16 + 8 synthetic calibration rows of 32 tokens from seed 1
QKW = dict(codebook="D4", nsamples=8, model_seqlen=32, batch_size=8,
           quip_tune_iters=1, ft_epochs=1, ft_train_size=16,
           ft_valid_size=8, ft_pp=2, ft_microbatches=8, seed=1)
# 4 batches of 8 rows (1 for the Hessians, 1 to validate): 2 steps
CLI_STEPS = 2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI on ``CLI_ARGS`` (``QuipQuantizer(ft_pp=2)`` through
    ``tests/test_finetune.py``'s pipelined route), once for the file:
    every ``quantize_layer`` call recorded, the finetune's stats, and the
    save directory."""
    d = str(tmp_path_factory.mktemp("jax"))
    calls, quantizers = [], []
    orig, orig_qm = JQQ.quantize_layer, JQQ.QuipQuantizer.quantize_model

    def spy(W, H, cb, qc, rng, **kw):
        st = rng.bit_generator.state
        a, w = orig(W, H, cb, qc, rng, **kw)
        calls.append((np.array(W), np.array(H), st, kw, qc, a))
        return a, w

    def quantize_model(self, *a, **kw):
        quantizers.append(self)
        return orig_qm(self, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JQQ, "quantize_layer", spy)
        mp.setattr(JQQ.QuipQuantizer, "quantize_model", quantize_model)
        j_quantize.main(CLI_ARGS + ["--save-dir", d])
    return calls, quantizers[0].e2e_ft_stats_, d


def test_quantize_model_ft_pp_matches_jax(ranks, jax_run, tmp_path):
    """The port's ``QuipQuantizer(ft_pp=2, ft_microbatches=8)`` on the
    ranks against the JAX package's pipelined run of the same settings
    (D4, 2 layers, 8 microbatches; ``jax_run``): codes, stats and the
    saved files."""
    jcalls, jstats, jdir = jax_run
    tcfg = tiny_config()
    calib = synthetic_tokens(8 + 16 + 8, 32, tcfg.vocab_size, seed=1)
    path = C.save_model(ranks, "dense", init_llama_params(tcfg, seed=1,
                                                          device="cpu"))
    outs = ranks.run("torch_sp_cases:quantize", tcfg, path, calib, QKW,
                     str(tmp_path / "port"))
    (tcalls, stats), other = outs[0], outs[1]
    assert other[1] == stats                 # every rank saw the same losses
    assert len(tcalls) == len(jcalls)
    names = [f"model.layers.{i}.{p}" for i in range(2)
             for p in ("self_attn.q_proj", "self_attn.k_proj",
                       "self_attn.v_proj", "self_attn.o_proj",
                       "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")]
    cb = get_codebook("D4")
    tied = [n for n, jc, tc in zip(names, jcalls, tcalls)
            if check_linear(n, jc, tc, cb) is not None]
    for k in ("initial", "best"):
        assert stats[k] == pytest.approx(jstats[k], rel=1e-4)
    assert stats["best"] <= stats["initial"]
    _same_dirs(jdir, str(tmp_path / "port"), CLI_STEPS, skip=tied)


def test_ft_pp_refusals():
    """ft_pp must divide the layers (the JAX package's ValueError, which
    it raises in its end-to-end finetune, once the blocks are quantized:
    called here on one batch of the float model; the port raises before
    it quantizes), and the port's ``quantize_model`` must run on a group
    of ft_pp ranks."""
    cfg, tcfg = jtiny(num_hidden_layers=3), tiny_config(num_hidden_layers=3)
    calib = synthetic_tokens(16, 16, cfg.vocab_size, seed=1)
    kw = dict(QKW, nsamples=8, ft_epochs=1, ft_train_size=4)
    ids = calib[:4]
    with pytest.raises(ValueError, match="must divide num_hidden_layers=3"):
        JQQ.QuipQuantizer(**kw)._finetune_end2end(
            cfg, JM.init_llama_params(cfg, seed=0), [ids, ids],
            [np.zeros((4, 16, cfg.hidden_size), np.float32)] * 2, 0, 1)
    with pytest.raises(ValueError, match="must divide num_hidden_layers=3"):
        QuipQuantizer(**kw).quantize_model(
            tcfg, init_llama_params(tcfg, device="cpu"), calib)
    two = tiny_config(num_hidden_layers=2)
    with pytest.raises(ValueError, match="the world size is 1"):
        QuipQuantizer(**kw).quantize_model(
            two, init_llama_params(two, device="cpu"), calib)


def test_cli_quantize_ft_pp_writes_the_jax_files(ranks, jax_run,
                                                 tmp_path):
    """``--ft-pp 2`` (the finetune's microbatches: the JAX CLI's
    ft_batch_size, 8) on the two ranks writes the JAX CLI's files
    (``jax_run``)."""
    jdir = jax_run[2]
    ranks.run("torch_sp_cases:cli", "quantize", CLI_ARGS + [
        "--save-dir", str(tmp_path / "port"), "--device", "cpu"])
    _same_dirs(jdir, str(tmp_path / "port"), CLI_STEPS)


def test_eval_ppl_sp_cli_matches_jax(ranks, capsys):
    """``eval_ppl --sp 2`` on the two ranks: rank 0 prints the JAX CLI's
    JSON line, its ppl within 1e-2 (relative; ``tests/test_torch_cli.py``'s
    rule); the other rank prints nothing; ``--sp 4`` on two ranks
    raises."""
    argv = ["--model-path", GOLDEN, "--dataset", "synthetic", "--nsamples",
            "4", "--seqlen", "32", "--sp", "2"]
    j_eval_ppl.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    outs = ranks.run("torch_sp_cases:cli", "eval_ppl", argv + ["--device",
                                                               "cpu"])
    assert outs[1] == ""
    got = json.loads(outs[0].strip())
    assert {k: v for k, v in got.items() if k != "ppl"} == {
        k: v for k, v in want.items() if k != "ppl"}
    assert abs(got["ppl"] - want["ppl"]) <= 1e-2 * want["ppl"]
    err = ranks.run("torch_sp_cases:cli_error", "eval_ppl", [
        "--model-path", GOLDEN, "--dataset", "synthetic", "--nsamples", "2",
        "--seqlen", "16", "--sp", "4", "--device", "cpu"])
    assert err[0] == ("ValueError", "--sp 4 needs a world of 4 ranks, not 2")
