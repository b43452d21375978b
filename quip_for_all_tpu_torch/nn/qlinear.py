"""QuantLinear / FusedQuantLinear: linear layers over lattice-coded weights —
``quip_for_all_tpu/nn/qlinear.py`` as ``nn.Module``s. The eval forward:

    x·SU → U_l^T x (wscale fused) → codebook matmul → per-channel scale
        → U_r out → slice pad → ·SV → +bias

Below the crossover the left transform is emitted straight into the fused
kernel's grouped layout (``matmul_hadUt_grouped``) and the per-channel scale
rides the kernel epilogue. There is no fallback around the kernel: only the
shape rules (q_out % 128, m < crossover, power-of-2 part >= 8) choose the
dense route, as in the JAX package, and a failed build or launch raises.

Two per-layer switches ride the fused route (``models/llama.py``
``set_right_in_kernel`` / ``set_combine_planes`` set them model-wide; the
JAX package's QFA_RIGHT_IN_KERNEL and QFA_COMBINE_PLANES, both off by
default there and here): ``right_in_kernel`` runs the right transform's
B-side factor in the kernel epilogue and ``finish_right`` the rest, where
``right_b_factor`` and ``can_fuse_right`` admit the shape (else the whole
``matmul_hadU`` runs after the kernel, as there); ``combine`` is the row
bound of the combined residual decode. ``switch_epoch`` counts changes of
any switch, so ``runtime/graphs.py`` recaptures a graph captured before
one.
The eval forward is differentiable in x (and SU/SV when they require grad):
a LoRA step takes gradients through the frozen base, through K3 on the
fused route (``ops/fused_matmul.py`` ``FusedQuantMatmul``) and through the
decoded W on the dense one. The training forward (``training=True``, a
``dense_weight`` or a ``W_cache``) multiplies by ``calc_weight``'s dense W,
with gradients to SU and SV.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops.dequant import decode_weights
from ..ops.fused_matmul import (can_fuse_right, fused_quant_matmul_pre,
                                supports)
from ..ops.qtensor import QuantizedTensor
from ..ops.quant_matmul import FUSED_MAX_M, quant_matmul
from ..transforms.incoherence import (HadSpec, finish_right,
                                      hadamard_transform, matmul_hadU,
                                      matmul_hadUt, matmul_hadUt_grouped,
                                      right_b_factor, right_hb_tensor)

_SWITCHES = {"epoch": 0}


def switch_epoch() -> int:
    """How many times a layer's ksplit, right_in_kernel or combine switch
    has changed in this process."""
    return _SWITCHES["epoch"]


def _grouped_prologue_matmul(x, spec, qt, scale, compute_dtype,
                             scale_vec=None, impl="auto",
                             max_m=FUSED_MAX_M, ksplit=0, right_spec=None,
                             combine=0):
    """The fused grouped-layout route (x in the lane order of the planes'
    subword split) as (out, right_done), or None when a shape rule sends
    the call to the plain transform + quant_matmul route. With
    ``right_spec`` (the switch on) the right transform's B-side factor
    runs in the kernel epilogue where ``right_b_factor`` and
    ``can_fuse_right`` admit it (right_done: the caller finishes with
    ``finish_right``), as ``_grouped_prologue_matmul`` in the JAX
    package."""
    if x.shape[0] >= max_m or not supports(qt):
        return None
    xg = matmul_hadUt_grouped(x, spec, qt.group_cols, scale=scale,
                              split=qt.split)
    if xg is None:
        return None
    right_hb = None
    if right_spec is not None:
        rb = right_b_factor(right_spec)
        if rb is not None and can_fuse_right(qt, rb[1]):
            right_hb = right_hb_tensor(right_spec.padN // right_spec.K,
                                       xg.device)
    out = fused_quant_matmul_pre(xg.to(compute_dtype), qt,
                                 scale_vec=scale_vec, plain=impl == "plain",
                                 ksplit=ksplit, right_hb=right_hb,
                                 combine=combine)
    return out, right_hb is not None


def same_tensor(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
                ) -> bool:
    """Both None, or equal in shape and value (the same object skips the
    comparison)."""
    if (a is None) != (b is None):
        return False
    return a is b or a is None or (a.shape == b.shape and torch.equal(a, b))


class _PlaneHolder(nn.Module):
    """Registers a QuantizedTensor's planes as buffers (so ``.to()`` moves
    them) and rebuilds the container on access."""

    def _set_qweight(self, qt: Optional[QuantizedTensor]):
        # the fused route's switches (models/llama.py set_ksplit,
        # set_right_in_kernel, set_combine_planes): split-K chunks (0 =
        # off), the right epilogue, the combined decode's row bound (0 =
        # off)
        self._switches = {"ksplit": 0, "right_in_kernel": False,
                          "combine": 0}
        # planes of any layout; pb's w0 and bfp's planes are 3-D buffers
        self.plane_keys = sorted(qt.planes) if qt is not None else []
        for k in self.plane_keys:
            self.register_buffer(f"planes_{k}", qt.planes[k])
        if qt is not None:
            self.codebook_id = qt.codebook_id
            self.opt_resid_scale = qt.opt_resid_scale
            self.layout = qt.layout

    def _switch(self, name, value):
        if self._switches[name] != value:
            self._switches[name] = value
            _SWITCHES["epoch"] += 1

    ksplit = property(lambda self: self._switches["ksplit"],
                      lambda self, v: self._switch("ksplit", int(v)))
    right_in_kernel = property(
        lambda self: self._switches["right_in_kernel"],
        lambda self, v: self._switch("right_in_kernel", bool(v)))
    combine = property(lambda self: self._switches["combine"],
                       lambda self, v: self._switch("combine", int(v)))

    @property
    def qweight(self) -> QuantizedTensor:
        if not self.plane_keys:
            raise RuntimeError("this layer holds no planes (fused segment)")
        return QuantizedTensor(
            {k: getattr(self, f"planes_{k}") for k in self.plane_keys},
            self.codebook_id, self.q_out, self.q_in, self.opt_resid_scale,
            self.layout)


class QuantLinear(_PlaneHolder):
    """One quantized linear layer (``QuantLinearParams`` + ``apply``).

    ``wscale_float`` is mean(Wscale), fused into the left transform's
    scale; ``Wscale`` (per-channel only) is already normalized by it.
    ``W_cache`` (None until a caller sets it) holds ``calc_weight``'s dense
    W for the training forward."""

    def __init__(self, qweight: Optional[QuantizedTensor], *,
                 in_features: int, out_features: int, q_in: int,
                 q_out: int, K_left: int = 1, K_right: int = 1,
                 SU=None, SV=None, bias=None, had_left=None, had_right=None,
                 Wscale=None, per_channel: bool = False,
                 wscale_float: float = 1.0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.q_in, self.q_out = q_in, q_out
        self.K_left, self.K_right = K_left, K_right
        self.per_channel = per_channel
        self.wscale_float = float(wscale_float)
        self._set_qweight(qweight)
        for name, t in (("SU", SU), ("SV", SV), ("bias", bias),
                        ("had_left", had_left), ("had_right", had_right),
                        ("Wscale", Wscale), ("W_cache", None)):
            self.register_buffer(name, t)

    @property
    def left_spec(self) -> HadSpec:
        return HadSpec(self.had_left, self.K_left, self.q_in)

    @property
    def right_spec(self) -> HadSpec:
        return HadSpec(self.had_right, self.K_right, self.q_out)

    def forward(self, x, *, training: bool = False,
                compute_dtype=torch.bfloat16, matmul_impl: str = "auto",
                max_m: int = FUSED_MAX_M, dense_weight=None):
        return apply(self, x, training=training, compute_dtype=compute_dtype,
                     matmul_impl=matmul_impl, max_m=max_m,
                     dense_weight=dense_weight)


def calc_weight(p: QuantLinear, dtype=torch.float32) -> torch.Tensor:
    """Dense weight (q_in, q_out) with eval ≡ x @ W before SU/SV/bias
    (``calc_weight`` in the JAX package). The per-channel scale goes before
    the right transform, as the JAX package keeps it consistent with its
    eval forward (its ``qlinear.py:135-140``)."""
    w = decode_weights(p.qweight, dtype=dtype)                # (q_out, q_in)
    if p.per_channel:
        w = w * p.Wscale.to(dtype)[:, None]
    w = matmul_hadU(w, p.left_spec, scale=p.wscale_float)     # ŵ U_l^T
    return matmul_hadU(w.T, p.right_spec)                     # U_l ŵ^T U_r^T


def apply(p: QuantLinear, x: torch.Tensor, *, training: bool = False,
          compute_dtype=torch.bfloat16, matmul_impl: str = "auto",
          max_m: int = FUSED_MAX_M,
          dense_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward. x: (..., in_features) -> (..., out_features). With
    ``training`` or a ``dense_weight`` (else ``p.W_cache``, else
    ``calc_weight``) x multiplies a dense W in x's dtype, as the JAX
    package's training forward does; otherwise the eval forward."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    x_dtype = x.dtype
    if p.SU is not None:
        x = x * p.SU.to(x_dtype)
    if training or dense_weight is not None:
        W = dense_weight if dense_weight is not None else p.W_cache
        if W is None:
            W = calc_weight(p, dtype=x_dtype)
        if x.shape[-1] != p.q_in:
            x = torch.nn.functional.pad(x, (0, p.q_in - x.shape[-1]))
        return _epilogue(p, (x @ W.to(x_dtype))[:, : p.out_features],
                         batch_shape)
    sv = p.Wscale if p.per_channel else None
    res = None
    if matmul_impl != "dequant":
        res = _grouped_prologue_matmul(
            x, p.left_spec, p.qweight, p.wscale_float, compute_dtype,
            scale_vec=sv, impl=matmul_impl, max_m=max_m, ksplit=p.ksplit,
            right_spec=p.right_spec if p.right_in_kernel else None,
            combine=p.combine)
    out, right_done = res if res is not None else (None, False)
    pc_fused = out is not None and sv is not None
    if out is None:
        x = matmul_hadUt(x, p.left_spec, scale=p.wscale_float)
        out = quant_matmul(x.to(compute_dtype), p.qweight, impl=matmul_impl,
                           max_m=max_m, ksplit=p.ksplit, combine=p.combine)
    out = out.to(x_dtype)
    if p.per_channel and not pc_fused:
        out = out * p.Wscale.to(x_dtype)
    if right_done:
        out = finish_right(out, p.right_spec)[:, : p.out_features]
    else:
        out = matmul_hadU(out, p.right_spec)[:, : p.out_features]
    return _epilogue(p, out, batch_shape)


def _epilogue(p: QuantLinear, out: torch.Tensor, batch_shape
              ) -> torch.Tensor:
    """·SV, the batch shape back, +bias."""
    if p.SV is not None:
        out = out * p.SV.to(out.dtype)
    out = out.reshape(*batch_shape, p.out_features)
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)
    return out


class FusedQuantLinear(_PlaneHolder):
    """Several QuantLinears sharing one input and one LEFT transform, fused
    into a single decode+matmul launch (q+k+v, gate+up). Code planes are
    concatenated along q_out; the per-segment right transforms, scales, SV
    and bias apply to the split output. With uniform segments the right
    side runs as one batched evaluation (``right_uniform``)."""

    def __init__(self, qweight: QuantizedTensor, segments: Sequence,
                 *, SU, had_left, K_left: int, q_in: int, in_features: int,
                 right_uniform: bool, right_hadK_stack=None, pre_vec=None,
                 SV_all=None, bias_all=None):
        super().__init__()
        self.q_in, self.q_out = q_in, qweight.q_out
        self.K_left, self.in_features = K_left, in_features
        self.right_uniform = right_uniform
        self._set_qweight(qweight)
        self.segments = nn.ModuleList(segments)
        for name, t in (("SU", SU), ("had_left", had_left),
                        ("right_hadK_stack", right_hadK_stack),
                        ("pre_vec", pre_vec), ("SV_all", SV_all),
                        ("bias_all", bias_all)):
            self.register_buffer(name, t)

    @property
    def left_spec(self) -> HadSpec:
        return HadSpec(self.had_left, self.K_left, self.q_in)

    def forward(self, x, *, compute_dtype=torch.bfloat16,
                matmul_impl: str = "auto", max_m: int = FUSED_MAX_M):
        return fused_apply(self, x, compute_dtype=compute_dtype,
                           matmul_impl=matmul_impl, max_m=max_m)


def _slim(p: QuantLinear) -> QuantLinear:
    """A segment keeps only its per-output metadata and arrays."""
    return QuantLinear(
        None, in_features=p.in_features, out_features=p.out_features,
        q_in=p.q_in, q_out=p.q_out, K_left=p.K_left, K_right=p.K_right,
        SV=p.SV, bias=p.bias, had_right=p.had_right, Wscale=p.Wscale,
        per_channel=p.per_channel, wscale_float=p.wscale_float)


def fuse_qlinears(ps: Sequence[QuantLinear]) -> FusedQuantLinear:
    """Fuse QuantLinears sharing identical left transforms."""
    p0 = ps[0]
    for p in ps[1:]:
        if (p.q_in != p0.q_in or p.K_left != p0.K_left
                or p.codebook_id != p0.codebook_id
                or p.layout != p0.layout):
            raise ValueError("fuse_qlinears: left sides differ")
    q0 = p0.qweight
    # segments concatenate along q_out: plane axis 0 for the 2-D planes
    # (the row-pair u3/pb planes too: each segment paired its own rows, so
    # no pair straddles a segment), axis 1 for pb's 3-D w0 and bfp's 3-D
    # planes
    planes = {k: torch.cat([p.qweight.planes[k] for p in ps],
                           dim=1 if v.dim() == 3 else 0)
              for k, v in q0.planes.items()}
    q_out = sum(p.q_out for p in ps)
    qt = QuantizedTensor(planes, q0.codebook_id, q_out, p0.q_in,
                         q0.opt_resid_scale, q0.layout)
    uniform = all(
        p.q_out == p0.q_out and p.out_features == p.q_out
        and p.K_right == p0.K_right
        and ((p.had_right is None) == (p0.had_right is None))
        for p in ps)
    hadK_stack = pre_vec = SV_all = bias_all = None
    dev = planes["w0"].device
    if uniform:
        if p0.had_right is not None:
            hadK_stack = torch.stack([p.had_right for p in ps])
        pre = []
        for p in ps:
            v = torch.full((p.q_out,), p.wscale_float, dtype=torch.float32,
                           device=dev)
            if p.per_channel:
                v = v * p.Wscale.to(torch.float32)
            pre.append(v)
        pre_vec = torch.cat(pre)
        if any(p.SV is not None for p in ps):
            SV_all = torch.cat(
                [p.SV.to(torch.float32) if p.SV is not None
                 else torch.ones(p.q_out, device=dev) for p in ps])
        if any(p.bias is not None for p in ps):
            bias_all = torch.cat(
                [p.bias.to(torch.float32) if p.bias is not None
                 else torch.zeros(p.out_features, device=dev) for p in ps])
    return FusedQuantLinear(
        qt, [_slim(p) for p in ps], SU=p0.SU, had_left=p0.had_left,
        K_left=p0.K_left, q_in=p0.q_in, in_features=p0.in_features,
        right_uniform=uniform, right_hadK_stack=hadK_stack, pre_vec=pre_vec,
        SV_all=SV_all, bias_all=bias_all)


def fused_apply(f: FusedQuantLinear, x: torch.Tensor, *,
                compute_dtype=torch.bfloat16, matmul_impl: str = "auto",
                max_m: int = FUSED_MAX_M) -> List[torch.Tensor]:
    """Forward through a fused group; per-segment outputs
    (..., out_features_i)."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    x_dtype = x.dtype
    if f.SU is not None:
        x = x * f.SU.to(x_dtype)
    res = None
    sv = f.pre_vec if f.right_uniform else None
    # the right epilogue takes uniform groups (one right spec for all
    # segments), as in the JAX package
    rspec = (f.segments[0].right_spec
             if f.right_uniform and f.right_in_kernel else None)
    if matmul_impl != "dequant":
        res = _grouped_prologue_matmul(x, f.left_spec, f.qweight, None,
                                       compute_dtype, scale_vec=sv,
                                       impl=matmul_impl, max_m=max_m,
                                       ksplit=f.ksplit, right_spec=rspec,
                                       combine=f.combine)
    big, right_done = res if res is not None else (None, False)
    pre_fused = big is not None and sv is not None
    if big is None:
        x = matmul_hadUt(x, f.left_spec)     # unscaled; wscale per segment
        big = quant_matmul(x.to(compute_dtype), f.qweight, impl=matmul_impl,
                           max_m=max_m, ksplit=f.ksplit, combine=f.combine)
    big = big.to(x_dtype)
    if f.right_uniform:
        # batched epilogue: one scale, one batched kron transform and one
        # (optional) stacked-hadK product for all segments together
        seg0 = f.segments[0]
        q_out, nseg = seg0.q_out, len(f.segments)
        spec = seg0.right_spec
        if right_done:
            Y = finish_right(big.reshape(-1, nseg, q_out), spec,
                             hadK_stack=f.right_hadK_stack)
        else:
            had_scale = 1.0 / math.sqrt(spec.padN // spec.K)
            Y = big if pre_fused else big * f.pre_vec.to(x_dtype)
            Y = Y.reshape(-1, nseg, spec.K, spec.padN // spec.K)
            Y = hadamard_transform(Y, had_scale)
            if f.right_hadK_stack is not None:
                Y = torch.einsum("mskp,sjk->msjp", Y,
                                 f.right_hadK_stack.to(Y.dtype))
        Y = Y.reshape(-1, nseg * q_out)
        if f.SV_all is not None:
            Y = Y * f.SV_all.to(Y.dtype)
        if f.bias_all is not None:
            Y = Y + f.bias_all.to(Y.dtype)
        return [Y[:, i * q_out:(i + 1) * q_out].reshape(*batch_shape, q_out)
                for i in range(nseg)]
    outs = []
    off = 0
    for p in f.segments:
        seg = big[:, off:off + p.q_out] * p.wscale_float
        off += p.q_out
        if p.per_channel:
            seg = seg * p.Wscale.to(x_dtype)
        seg = matmul_hadU(seg, p.right_spec)[:, : p.out_features]
        if p.SV is not None:
            seg = seg * p.SV.to(seg.dtype)
        seg = seg.reshape(*batch_shape, p.out_features)
        if p.bias is not None:
            seg = seg + p.bias.to(seg.dtype)
        outs.append(seg)
    return outs
