"""Per-layer QuIP# quantization — counterpart of
``quip_for_all_tpu/quantize/quip.py``.

The heavy math (incoherence transforms, float64 Cholesky, LDLQ and the
nearest-codeword rounding) runs on ``device``, the card unless the caller
asks for the CPU, in full f32 (``ldlq.full_f32``). The host keeps what the
JAX package keeps there: the numpy ``Generator`` draws of the sign vectors
and of the random Hadamard factors (``transforms/incoherence.py``
``get_hadK(rng=...)``: the same draws and QR, so for one seed both packages
make the same signs and factors, bit for bit), and the small attrs record.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..nn.qlinear import QuantLinear
from ..ops.qtensor import from_raw_idxs
from ..transforms.incoherence import (HadSpec, get_hadK, matmul_hadU,
                                      matmul_hadUt)
from ..utils.device import resolve_device
from .ldlq import full_f32, ldlq

logger = logging.getLogger(__name__)

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class QuantConfig:
    """Knobs of one layer's quantization (the JAX package's QuantConfig)."""
    rescale_WH: bool = False
    sigma_reg: float = 0.01
    scale_override: float = -1.0
    use_rand: bool = True
    per_channel: bool = False
    quip_tune_iters: int = 10


@dataclasses.dataclass
class LayerQuantAttrs:
    """What quantizing one linear layer produces (host numpy)."""
    Qidxs_raw: np.ndarray          # (q_out, q_in/codesz) int32 raw codes
    w_scale: np.ndarray            # () or (q_out, 1)
    SU: np.ndarray                 # (in,) signs (or merged-in scale vector)
    SV: np.ndarray                 # (out,)
    left_spec: HadSpec
    right_spec: HadSpec
    merge_su: bool
    merge_sv: bool
    scaleWH: Optional[np.ndarray]  # (in,) when rescale_WH


def _t(a: Array, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if isinstance(
        a, np.ndarray) else a, device=device).to(torch.float32)


def _transform_H(H, SU, lspec):
    Hs = H * SU[None, :]
    Hs = matmul_hadUt(Hs, lspec)
    Hs = Hs.T * SU[None, :]
    return matmul_hadUt(Hs, lspec)


def _transform_W(W, SU, SV, lspec, rspec):
    Ws = W.T * SV[None, :]
    Ws = matmul_hadUt(Ws, rspec)
    Ws = Ws.T * SU[None, :]
    return matmul_hadUt(Ws, lspec)


def _reconstruct(hatW, SU, SV, lspec, rspec, n_in, n_out):
    w = matmul_hadU(hatW, lspec)[..., :n_in] * SU[None, :]
    w = matmul_hadU(w.T, rspec)[..., :n_out] * SV[None, :]
    return w.T


def _cholesky(Hr: torch.Tensor, sigma_reg: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 Cholesky with sigma_reg added to the diagonal before every
    attempt, the first one included (up to 10). Returns (L f32, the
    regularized Hr f32)."""
    Hr64 = Hr.to(torch.float64)
    for attempt in range(10):
        Hr64.diagonal().add_(sigma_reg)
        L, info = torch.linalg.cholesky_ex(Hr64)
        if int(info) == 0 and not bool(torch.isnan(L).any()):
            return L.to(torch.float32), Hr64.to(torch.float32)
        logger.warning("Cholesky failed (attempt %d), escalating sigma_reg",
                       attempt + 1)
    raise ValueError("Hessian is not invertible")


def quantize_layer(
    W: Array,
    H: Array,
    cb,
    cfg: QuantConfig,
    rng: np.random.Generator,
    SU: Optional[np.ndarray] = None,
    SV: Optional[np.ndarray] = None,
    lspec: Optional[HadSpec] = None,
    rspec: Optional[HadSpec] = None,
    su_is_merged: Optional[bool] = None,
    sv_is_merged: Optional[bool] = None,
    device="cuda",
    on_step=None,
) -> Tuple[LayerQuantAttrs, torch.Tensor]:
    """Quantize one linear layer.

    W: (out, in) float; H: (in, in) input second moment (numpy or tensors).
    SU/SV: optional merged or shared sign vectors; lspec/rspec: optional
    transform overrides. The numpy ``rng`` is drawn in the JAX package's
    order: SU, SV, then the left factor, then the right one. Returns
    (attrs, W_hat (out, in) f32 on ``device``): the dense reconstruction.
    ``on_step`` goes to ``ldlq``.
    """
    dev = resolve_device(device)
    with full_f32():
        return _quantize_layer(W, H, cb, cfg, rng, SU, SV, lspec, rspec,
                               su_is_merged, sv_is_merged, dev, on_step)


def _quantize_layer(W, H, cb, cfg, rng, SU, SV, lspec, rspec, su_is_merged,
                    sv_is_merged, dev, on_step):
    W = _t(W, dev).clone()
    H = _t(H, dev).clone()
    n_out, n_in = W.shape

    # dead-column patching
    dead = torch.diagonal(H) == 0
    di = torch.nonzero(dead).flatten()
    H[di, di] = 1.0
    W[:, dead] = 0.0

    H /= torch.mean(torch.diagonal(H))

    scaleWH = None
    if cfg.rescale_WH:
        H /= torch.abs(H).max()
        diagH = torch.clamp(torch.diagonal(H), min=1e-8)
        diagW2 = torch.clamp((W * W).sum(dim=0), min=1e-8)
        scaleWH = torch.clamp(torch.sqrt(torch.sqrt(diagH / diagW2)),
                              min=1e-8)
        W = W * scaleWH[None, :]
        H = H / scaleWH[None, :]
        H = H / scaleWH[:, None]

    merge_su = (SU is not None) if su_is_merged is None else su_is_merged
    merge_sv = (SV is not None) if sv_is_merged is None else sv_is_merged
    if SU is None:
        SU = np.sign(rng.standard_normal(n_in) + 1e-5).astype(np.float32)
    if SV is None:
        SV = np.sign(rng.standard_normal(n_out) + 1e-5).astype(np.float32)
    SU = np.asarray(torch.as_tensor(SU).cpu(), np.float32)
    SV = np.asarray(torch.as_tensor(SV).cpu(), np.float32)
    if lspec is None:
        lspec = get_hadK(n_in, use_rand=cfg.use_rand, rng=rng)
    if rspec is None:
        rspec = get_hadK(n_out, use_rand=cfg.use_rand, rng=rng)
    SU_t, SV_t = _t(SU, dev), _t(SV, dev)

    Hr = _transform_H(H, SU_t, lspec)
    Wr = _transform_W(W, SU_t, SV_t, lspec, rspec)
    L, Hr = _cholesky(Hr, cfg.sigma_reg)

    if cfg.per_channel:
        w_scale = torch.sqrt((Wr * Wr).mean(dim=1, keepdim=True))
    else:
        w_scale = torch.sqrt((Wr * Wr).mean())
    w_scale = w_scale / (cfg.scale_override if cfg.scale_override > 0
                         else cb.opt_scale)

    hatWr, Qidxs = ldlq(Wr / w_scale, Hr, L, cb, cfg.quip_tune_iters,
                        on_step)
    hatWr = hatWr * w_scale

    W_hat = _reconstruct(hatWr, SU_t, SV_t, lspec, rspec, n_in, n_out)
    if scaleWH is not None:
        W_hat = W_hat / scaleWH[None, :]

    attrs = LayerQuantAttrs(
        Qidxs_raw=Qidxs.cpu().numpy(),
        w_scale=w_scale.cpu().numpy().astype(np.float32),
        SU=SU, SV=SV, left_spec=lspec, right_spec=rspec,
        merge_su=merge_su, merge_sv=merge_sv,
        scaleWH=None if scaleWH is None else
        scaleWH.cpu().numpy().astype(np.float32))
    return attrs, W_hat


def pack_to_qlinear(attrs: LayerQuantAttrs, cb,
                    bias: Optional[Array] = None,
                    per_channel: bool = False, device="cuda",
                    layout: Optional[str] = None) -> QuantLinear:
    """The runtime ``QuantLinear`` of a quantized layer, on ``device``:
    wscale_float = mean(w_scale), a per-channel Wscale normalized by it,
    all-ones SU/SV (the merged case) dropped. With rescale_WH the codes
    approximate W·scaleWH, so the input is divided by scaleWH (the JAX
    package's direction)."""
    dev = resolve_device(device)
    lspec, rspec = attrs.left_spec, attrs.right_spec
    n_in, n_out = attrs.SU.shape[0], attrs.SV.shape[0]
    if attrs.scaleWH is not None and not attrs.merge_su:
        SU = attrs.SU / attrs.scaleWH
    elif attrs.scaleWH is not None:
        SU = 1.0 / attrs.scaleWH
    elif not attrs.merge_su:
        SU = attrs.SU
    else:
        SU = None
    SV = None if attrs.merge_sv else attrs.SV
    if SU is not None and np.all(SU == 1.0):
        SU = None
    if SV is not None and np.all(SV == 1.0):
        SV = None

    ws = attrs.w_scale.reshape(-1)
    wscale_float = float(ws.mean())
    Wscale = (_t((ws / ws.mean()).astype(np.float32), dev) if per_channel
              else None)
    if bias is not None:
        bias = np.asarray(torch.as_tensor(bias).cpu(), np.float32)
        if attrs.merge_sv:
            bias = bias / attrs.SV

    def opt(a):
        return None if a is None else _t(np.asarray(torch.as_tensor(
            a).cpu(), np.float32), dev)
    qt = from_raw_idxs(cb, attrs.Qidxs_raw, rspec.padN, lspec.padN,
                       device=dev, layout=layout)
    return QuantLinear(
        qt, in_features=n_in, out_features=n_out, q_in=lspec.padN,
        q_out=rspec.padN, K_left=lspec.K, K_right=rspec.K, SU=opt(SU),
        SV=opt(SV), bias=opt(bias), had_left=opt(lspec.hadK),
        had_right=opt(rspec.hadK), Wscale=Wscale, per_channel=per_channel,
        wscale_float=wscale_float, shards_left=lspec.shards,
        shards_right=rspec.shards)


def proxy_loss(W: torch.Tensor, W_hat: torch.Tensor, H: torch.Tensor
               ) -> float:
    """tr((W - Ŵ) H (W - Ŵ)ᵀ) / tr(W H Wᵀ): the layer's output error on
    the calibration inputs relative to its output, in f64 on H's device."""
    W = W.to(device=H.device, dtype=torch.float64)
    E = W - W_hat.to(device=H.device, dtype=torch.float64)
    H = H.to(torch.float64)
    return float(torch.sum((E @ H) * E) / torch.sum((W @ H) * W))
