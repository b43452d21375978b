"""The port's quality matrix (``tools/quality_matrix.py`` of the port)
held to the JAX package's ``tools/quality_matrix.py`` on the CPU: the
training loop of ``train_tiny`` (8 steps at d=128 from the same draws:
every weight within 1e-4 of the model's max|w| of optax's loop, where
JAX's gradient stayed clear of zero), the
teacher-forced ppl through an f32 and an int8 KV cache on one checkpoint
written by JAX's quantizer (within 1e-4, relative), and one E8P12 cell
end to end through the port's CLIs (``--device cpu``, as subprocesses) at
the smallest size that still trains, writing a table and its JSON.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from quip_for_all_tpu.data.calibration import synthetic_tokens
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import tiny_config as jtiny
from quip_for_all_tpu.quantize.quantizer import QuipQuantizer as JQ
from quip_for_all_tpu.utils import checkpoint as jckpt

from quip_for_all_tpu_torch.models.config import tiny_config
from quip_for_all_tpu_torch.models.llama import init_llama_params
from quip_for_all_tpu_torch.tools import quality_matrix as Q
from quip_for_all_tpu_torch.utils.convert import from_jax_params

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    """The JAX package's ``tools/quality_matrix.py`` (not a package: loaded
    by its file; nothing of it runs at import)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quality_matrix", os.path.join(ROOT, "tools", "quality_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_loop_matches_optax():
    """JAX's ``train_tiny`` loop (its loss, ``optax.adam(2e-3)``, batches of
    16 in order) against the port's ``fit`` for 8 steps at d=128 from the
    same initial draws (``init_llama_params``, seed 0): the losses, and
    every weight within 1e-4 of the model's max|w| (the norms' 1) where
    JAX's gradient stayed 0 or above 1e-5 of its leaf's max|g| at every
    step. Below that, Adam's step (g over |g| + 1e-8) turns the two
    packages' f32 sum-order noise (~1e-6 of max|g|) into other steps of up
    to lr (the rule of ``chip_smoke.py``'s ``train_hold``); those elements
    must be few (146 of 361088 when measured)."""
    steps = 8
    jcfg = jtiny(num_hidden_layers=2, hidden_size=128, intermediate_size=256)
    cfg = tiny_config(num_hidden_layers=2, hidden_size=128,
                      intermediate_size=256)
    data = synthetic_tokens(Q.TRAIN_N, Q.SEQ, cfg.vocab_size,
                            seed=Q.TRAIN_SEED)[:steps * Q.BATCH]
    params = JM.init_llama_params(jcfg, seed=0)

    def loss_fn(params, ids):
        logits, _ = JM.model_apply(jcfg, params, ids)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, ids[:, 1:, None], -1).mean()

    opt = optax.adam(Q.LR)
    state = opt.init(params)

    @jax.jit
    def step(params, state, ids):
        loss, g = jax.value_and_grad(loss_fn)(params, ids)
        upd, state = opt.update(g, state, params)
        small = jax.tree_util.tree_map(      # an unseen token's row: 0
            lambda x: (x != 0) & (jnp.abs(x) < 1e-5 * jnp.abs(x).max()), g)
        return optax.apply_updates(params, upd), state, loss, small

    flips = None
    for i in range(0, data.shape[0], Q.BATCH):
        params, state, jloss, small = step(params, state,
                                           jnp.asarray(data[i:i + Q.BATCH]))
        flips = small if flips is None else jax.tree_util.tree_map(
            jnp.logical_or, flips, small)
    model = init_llama_params(cfg, seed=0, device="cpu")
    loss = Q.fit(cfg, model, data, epochs=1)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = dict(from_jax_params(params, "cpu").named_buffers())
    masks = dict(from_jax_params(jax.tree_util.tree_map(
        lambda m: m.astype(jnp.float32), flips), "cpu").named_buffers())
    got = dict(model.named_buffers())
    assert sorted(got) == sorted(want)
    scale = max(float(w.abs().max()) for w in want.values())
    masked = 0
    for k, w in want.items():
        assert not got[k].requires_grad
        keep = masks[k] == 0
        masked += int((~keep).sum())
        err = float(((got[k] - w).abs() * keep).max())
        assert err <= 1e-4 * scale, (k, err, scale)
    assert masked <= 1e-3 * sum(w.numel() for w in want.values()), masked
    print(json.dumps({"masked": masked, "of": sum(w.numel() for w in
                                                 want.values())}))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny llama quantized (E8P12) and saved by the JAX package."""
    cfg = jtiny(num_hidden_layers=1)
    q = JQ(codebook="E8P12", nsamples=8, batch_size=4, quip_tune_iters=0,
           ft_epochs=0)
    qp = q.quantize_model(cfg, JM.init_llama_params(cfg, seed=0),
                          synthetic_tokens(8, 32, cfg.vocab_size, seed=1))
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.save_quantized(cfg, qp, q.to_dict(), d)
    return d


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_kv_ppl_matches_jax(jax_checkpoint, quantized):
    """Teacher-forced ppl through the KV cache (both draws) on JAX's
    checkpoint: the port's ``kv_ppl_both`` against JAX's."""
    want = _jax_tool().kv_ppl_both(jax_checkpoint, quantized)
    got = Q.kv_ppl_both(jax_checkpoint, quantized, device="cpu")
    assert np.allclose(got, want, rtol=1e-4, atol=0), (got, want)


def test_e8p12_cell_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``--fast`` (the E8P12 cell on the main model) at d=64 and 2048
    training windows, two epochs (smaller models or fewer steps stay near
    the uniform ppl): the model trains (fp32 ppl under 0.75 of the uniform
    256; 174 when measured), the cell's quantize and eval_ppl subprocesses
    run, and the table and JSON parse with the JAX run's numbers beside
    them."""
    # one thread in the CLI subprocesses too (a parallel test run
    # otherwise oversubscribes the cores)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(Q, "MAIN_D", 64)
    monkeypatch.setattr(Q, "TRAIN_N", 2048)
    monkeypatch.setattr(Q, "EPOCHS", 2)
    out = tmp_path / "QUALITY_TORCH.md"
    payload = Q.main(["--fast", "--device", "cpu", "--workdir",
                      str(tmp_path / "work"), "--out", str(out)])
    with open(tmp_path / "QUALITY_TORCH.json") as f:
        assert json.load(f) == json.loads(json.dumps(payload))
    fp_h, fp_t = payload["main_fp32"]
    assert fp_h < 0.75 * 256 and fp_t < 0.75 * 256, payload
    (cb, variant, q_h, q_t), = payload["main"]
    assert (cb, variant) == ("E8P12", "base")
    assert np.isfinite(q_h) and np.isfinite(q_t) and q_h < 256, payload
    assert payload["device"] == "CPU"
    text = out.read_text()
    assert "## Main matrix — d=64" in text and "on **CPU**" in text
    row = [line for line in text.splitlines()
           if line.startswith("| E8P12 | 2 | base |")]
    assert len(row) == 1
    cells = [c.strip() for c in row[0].strip("|").split("|")]
    assert float(cells[3]) == round(q_h, 3)
    assert cells[7] == "84.647"       # JAX's held-out ppl of the cell
