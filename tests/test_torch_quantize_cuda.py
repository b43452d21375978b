"""Quantization on a card against the same calls on the CPU. This file
imports neither JAX nor the JAX package (the card's machine has no JAX),
so it runs there without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quantize_cuda.py

Without a card every test skips. The card and the CPU sum in other orders
(the score products, the f64 Hessian and Cholesky), so codes may part at
near-ties and LDLQ's carry spreads a flip along its row: the codes'
agreement is printed and the proxy loss held within 2% of the CPU run's;
TF32 must be off inside every quantize call.
"""
import numpy as np
import pytest
import torch

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.quantize import quip

pytestmark = [pytest.mark.fast, pytest.mark.cuda]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _layer(n_out=512, n_in=1024, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((4096, n_in)).astype(np.float32)
    X *= rng.uniform(0.2, 2.0, n_in).astype(np.float32)
    H = (X.T @ X / X.shape[0]).astype(np.float32)
    W = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(
        np.float32)
    return W, H


@pytest.mark.parametrize("codebook", ["E8P12", "E8P12RVQ4B"])
def test_quantize_layer_card_vs_cpu(codebook, monkeypatch):
    W, H = _layer()
    cb = get_codebook(codebook)
    flags = []
    orig = type(cb).quantize

    def spy(self, X, chunk=None):
        flags.append((torch.backends.cuda.matmul.allow_tf32,
                      torch.get_float32_matmul_precision(), X.device.type))
        return orig(self, X, chunk)
    monkeypatch.setattr(type(cb), "quantize", spy)
    cfg = quip.QuantConfig(quip_tune_iters=2)
    out = {}
    for dev in ("cuda", "cpu"):
        attrs, W_hat = quip.quantize_layer(W, H, cb, cfg,
                                           np.random.default_rng(3),
                                           device=dev)
        assert W_hat.device.type == dev
        out[dev] = (attrs, quip.proxy_loss(torch.from_numpy(W), W_hat.cpu(),
                                           torch.from_numpy(H)))
    assert {f[:2] for f in flags} == {(False, "highest")}
    assert {f[2] for f in flags} == {"cuda", "cpu"}
    (ga, gp), (ca, cp) = out["cuda"], out["cpu"]
    assert np.array_equal(ga.SU, ca.SU) and np.array_equal(ga.SV, ca.SV)
    agree = float(np.mean(ga.Qidxs_raw == ca.Qidxs_raw))
    print(f"{codebook}: codes agree {agree:.4f}, proxy loss card {gp:.6f} "
          f"cpu {cp:.6f}")
    assert abs(gp - cp) <= 0.02 * cp
    layer = quip.pack_to_qlinear(ga, cb, device="cuda")
    x = torch.randn(3, W.shape[1], device="cuda")
    y = layer(x, compute_dtype=torch.float32)
    assert torch.isfinite(y).all() and y.shape == (3, W.shape[0])


def test_quantize_model_on_the_card():
    """A tiny model quantized where it lives (the card), its codes beside
    the CPU run's, and its logits finite."""
    cfg = qt.tiny_config()
    calib = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))
    models = {}
    for dev in ("cuda", "cpu"):
        q = qt.QuipQuantizer(codebook="E8P12", nsamples=8, batch_size=4,
                             quip_tune_iters=1, quantize_lm_head=True)
        models[dev] = q.quantize_model(
            cfg, qt.init_llama_params(cfg, seed=0, device=dev), calib)
    a, b = models["cuda"].state_dict(), models["cpu"].state_dict()
    planes = [k for k in a if "planes_" in k]
    agree = np.mean([torch.equal(a[k].cpu(), b[k]) for k in planes])
    print(f"tiny llama: {agree:.3f} of plane tensors equal card vs cpu")
    ids = torch.arange(12, device="cuda")[None] % cfg.vocab_size
    logits, _ = qt.get_arch(cfg).model_apply(
        cfg, models["cuda"], ids, linear_kw={"compute_dtype": torch.float32})
    assert torch.isfinite(logits).all()
