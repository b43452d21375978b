"""Shared helpers of the quantization parity tests: run the JAX and the
port's ``QuipQuantizer`` on the same tiny model and calibration tokens,
recording what each hands to ``quantize_layer``, and tell a code that
differs at a near-tie of the rounding from one that differs for another
reason.

A linear whose codes differ is accepted only when the first code that
differs, in the LDLQ's own order (the sweep, then each tune pass; block
columns right to left), sits at a near-tie: JAX's top-two score gap for
that row under ``NEAR_TIE`` of the row's score scale. The JAX side of that
step is replayed by the port's ``quantize_layer`` on the JAX call's own
inputs (W, H and the generator's state), which reproduces the JAX codes
(asserted). The linear's proxy loss must then be within 1% of JAX's.
"""
import numpy as np
import torch

import quip_for_all_tpu.quantize.quantizer as JQQ

import quip_for_all_tpu_torch.quantize.quantizer as TQQ
from quip_for_all_tpu_torch.quantize import quip as tquip

NEAR_TIE = 1e-5


def run_both(monkeypatch, cfg, tcfg, jparams, tmodel, calib, **qkw):
    """Quantize with both packages; returns (jax params, port model,
    jax calls, port calls, jax quantizer, port quantizer). A call is
    (W, H, rng state before the call, kwargs, QuantConfig, attrs)."""
    jcalls, tcalls = [], []
    oj, ot = JQQ.quantize_layer, TQQ.quantize_layer

    def spy_j(W, H, cb, qc, rng, **kw):
        st = rng.bit_generator.state
        a, w = oj(W, H, cb, qc, rng, **kw)
        jcalls.append((np.array(W), np.array(H), st, kw, qc, a))
        return a, w

    def spy_t(W, H, cb, qc, rng, **kw):
        st = rng.bit_generator.state
        a, w = ot(W, H, cb, qc, rng, **kw)
        tcalls.append((W.cpu().numpy(), H.cpu().numpy(), st, kw, qc, a))
        return a, w
    monkeypatch.setattr(JQQ, "quantize_layer", spy_j)
    monkeypatch.setattr(TQQ, "quantize_layer", spy_t)
    jq = JQQ.QuipQuantizer(**qkw)
    jp = jq.quantize_model(cfg, jparams, calib)
    tq = TQQ.QuipQuantizer(**qkw)
    tm = tq.quantize_model(tcfg, tmodel, calib)
    monkeypatch.undo()
    return jp, tm, jcalls, tcalls, jq, tq


def _trace(call, cb, **over):
    """The port's quantize_layer on a recorded call, every rounding's
    (pass, k) -> (X, codes) kept."""
    W, H, st, kw, qc, _ = call
    steps = {}

    def on_step(p, k, X, idx):
        steps[(p, k)] = (X.clone(), idx.clone())
    rng = np.random.default_rng()
    rng.bit_generator.state = st
    kw = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items() if k != "device"}
    attrs, W_hat = tquip.quantize_layer(
        W, H, cb, tquip.QuantConfig(**vars(qc)), rng, device="cpu",
        on_step=on_step, **kw)
    return steps, attrs, W_hat


def _gap(cb, x: torch.Tensor) -> float:
    """Top-two gap of one row's scores over its score scale."""
    g = torch.as_tensor(cb.grid(), dtype=torch.float32)
    s = 2.0 * (g @ x) - (g * g).sum(-1)
    top = torch.topk(s, 2).values
    return float((top[0] - top[1]) / s.abs().max())


def check_linear(name, jcall, tcall, tcb):
    """None when the codes are equal; else asserts the near-tie rule and
    the proxy-loss rule and returns the mismatch's margins."""
    ja, ta = jcall[5], tcall[5]
    if np.array_equal(ja.Qidxs_raw, ta.Qidxs_raw):
        return None
    jsteps, jattrs, _ = _trace(jcall, tcb)
    assert np.array_equal(jattrs.Qidxs_raw, ja.Qidxs_raw), name
    tsteps, _, _ = _trace(tcall, tcb)
    first = next(key for key in sorted(jsteps, key=lambda t: (t[0], -t[1]))
                 if not torch.equal(jsteps[key][1], tsteps[key][1]))
    X, idx = jsteps[first]
    rows = torch.nonzero(idx != tsteps[first][1]).flatten()
    gap = max(_gap(tcb, X[r]) for r in rows)
    assert gap < NEAR_TIE, (name, first, gap)

    def ploss(call, attrs):
        W, H = call[0], call[1]
        _, _, W_hat = _trace(call, tcb)
        return tquip.proxy_loss(torch.from_numpy(W), W_hat,
                                torch.from_numpy(H))
    pj, pt = ploss(jcall, ja), ploss(tcall, ta)
    assert abs(pt - pj) <= 0.01 * pj, (name, pj, pt)
    return {"linear": name, "step": first, "rows": len(rows), "gap": gap,
            "codes_differ": int((ja.Qidxs_raw != ta.Qidxs_raw).sum()),
            "proxy_jax": pj, "proxy_port": pt}
