"""Hessian (input second-moment) accumulation for proxy-loss quantization
— counterpart of ``quip_for_all_tpu/quantize/hessian.py``.

The JAX package sums x xᵀ in f32 with Kahan compensation (the TPU has no
fast fp64); the port sums in float64 on the activations' device, which a
card does at full rate. ``finalize`` returns the f32 mean: the reference's
2/N factor is dropped because quantization renormalizes H by its mean
diagonal anyway.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class HessianState:
    H: torch.Tensor          # (n, n) f64 sum of x xᵀ
    count: int               # rows accumulated

    @staticmethod
    def zeros(n: int, device="cpu") -> "HessianState":
        return HessianState(torch.zeros((n, n), dtype=torch.float64,
                                        device=device), 0)


def accumulate(state: HessianState, x: torch.Tensor) -> HessianState:
    """Add a batch of activations x (..., n) to the running second moment
    (in place; the state is returned for the JAX package's call form)."""
    x = x.reshape(-1, x.shape[-1]).to(device=state.H.device,
                                      dtype=torch.float64)
    state.H.addmm_(x.T, x)
    state.count += x.shape[0]
    return state


def finalize(state: HessianState) -> torch.Tensor:
    """Mean second moment (n, n), f32."""
    return (state.H / max(state.count, 1)).to(torch.float32)
