"""Incoherence transforms (randomized Hadamard / orthogonal factors) in
torch — counterpart of ``quip_for_all_tpu/transforms/incoherence.py``.

For dimension n = K * 2^e the transform is the orthogonal matrix

    U = (hadK ⊗ H_{2^e}) / sqrt(padN / K)

with H the Sylvester-Hadamard matrix and hadK a random orthogonal factor,
a table Hadamard factor (use_rand=False) or absent (K == 1).
``matmul_hadU(X) = X @ U^T`` along the last axis; ``matmul_hadUt(X) = X @ U``.
H_{2^e} = H_{2^a} ⊗ H_{2^b} is evaluated as two small dense products on a
(..., 2^a, 2^b) reshape, the same factorisation as the JAX package, so both
packages sum in the same grouping. These are dense products outside any
kernel in the JAX package too; here they go to torch.einsum.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .hadamard_tables import hadamard_matrix

Array = Union[np.ndarray, torch.Tensor]


def decompose_pow2(n: int) -> Tuple[int, int]:
    """n = odd_base * 2^exp -> (exp, odd_base)."""
    exp = 0
    while n % 2 == 0:
        n //= 2
        exp += 1
    return exp, n


def next_power_of_2(n: int) -> int:
    return 1 if n == 0 else 2 ** math.ceil(math.log2(n))


@lru_cache(maxsize=None)
def sylvester(e: int) -> np.ndarray:
    """Unnormalized Sylvester-Hadamard matrix of order 2^e (float32)."""
    H = np.ones((1, 1), dtype=np.float32)
    for _ in range(e):
        H = np.block([[H, H], [H, -H]])
    return H


@lru_cache(maxsize=64)
def _sylvester_t(e: int, device: torch.device, dtype: torch.dtype
                 ) -> torch.Tensor:
    return torch.as_tensor(sylvester(e), dtype=dtype, device=device)


def random_orthogonal_np(n: int, rng: np.random.Generator) -> np.ndarray:
    """Haar-random orthogonal matrix from a numpy ``Generator``: the JAX
    package's ``random_orthogonal`` draw for draw (one (n, n) Gaussian,
    ``np.linalg.qr``, the sign fix), so the factor is bitwise its own for
    the same generator state. f32 numpy, on the host like the QR."""
    A = rng.standard_normal((n, n))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))[None, :]
    return Q.astype(np.float32)


def random_orthogonal(n: int, generator: torch.Generator,
                      device="cpu") -> torch.Tensor:
    """Haar-random orthogonal matrix (QR of a Gaussian with sign fix), f32.
    The Gaussian is drawn on ``device`` from ``generator``; the small QR
    runs on the host in float64."""
    A = torch.randn((n, n), generator=generator, device=device,
                    dtype=torch.float64).cpu()
    Q, R = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diagonal(R))[None, :]
    return Q.to(device=device, dtype=torch.float32)


@dataclass(frozen=True)
class HadSpec:
    """The orthogonal factor for one dimension: hadK (K x K or None), K,
    and the transform length padN (>= n; zero-pad when larger). With
    ``shards`` > 1 the transform is block-diagonal, U = I_shards ⊗ U_sub
    with U_sub acting on padN / shards (hadK and K then describe U_sub):
    a tensor-parallel shard of that dimension applies its own block
    (``parallel/sharding.py``)."""
    hadK: Optional[Array]
    K: int
    padN: int
    shards: int = 1

    def sub(self) -> "HadSpec":
        """One diagonal block: the transform of length padN / shards."""
        return HadSpec(self.hadK, self.K, self.padN // self.shards)


def get_hadK(n: int, use_rand: bool = True,
             generator: Optional[torch.Generator] = None,
             device="cpu", rng: Optional[np.random.Generator] = None,
             shards: int = 1) -> HadSpec:
    """The factor for dimension n. With ``use_rand`` the K x K factor is
    drawn from ``rng`` (a numpy ``Generator``: the quantizer's path, the
    JAX package's draws and QR, f32 numpy) or else from ``generator`` (a
    torch one: ``random_quantized_model``'s path, a tensor on ``device``).
    With ``shards`` > 1 the block-diagonal transform of n (``HadSpec``),
    its sub-factor drawn for n / shards from the same source, as the JAX
    package draws it."""
    if shards > 1:
        if n % shards:
            raise ValueError(f"{n} does not split into {shards} shards")
        sub = get_hadK(n // shards, use_rand=use_rand, generator=generator,
                       device=device, rng=rng)
        if sub.padN != n // shards:
            raise ValueError(f"a shard of {n} pads to {sub.padN}: no "
                             "block-diagonal transform")
        return HadSpec(sub.hadK, sub.K, n, shards)
    exp, base = decompose_pow2(n)
    if base == 1:
        return HadSpec(None, 1, n)
    if use_rand:
        if rng is not None:
            return HadSpec(random_orthogonal_np(base, rng), base, n)
        if generator is None:
            raise ValueError("use_rand=True needs an explicit generator")
        return HadSpec(random_orthogonal(base, generator, device), base, n)
    # table factor of order base*4 (needs exp >= 2), bit-identical to the
    # reference asset: use_rand=False checkpoints recompute it at load
    tbl = hadamard_matrix(base * 4) if exp >= 2 else None
    if tbl is None:
        # pad to the next power of two with no leading factor
        return HadSpec(None, 1, next_power_of_2(n))
    return HadSpec((tbl / math.sqrt(base * 4)).astype(np.float32),
                   base * 4, n)


def _kron_split(e: int) -> Tuple[int, int]:
    b = min(e, 7)
    return e - b, b  # (high-bits factor, low-bits factor)


def _as(t: Array, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def hadamard_transform(X: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Unnormalized WHT along the last axis (length 2^e), times scale."""
    n = X.shape[-1]
    e = n.bit_length() - 1
    if (1 << e) != n:
        raise ValueError(f"hadamard_transform needs power-of-2 dim, got {n}")
    if e == 0:
        return X * scale
    ea, eb = _kron_split(e)
    A, B = 1 << ea, 1 << eb
    Hb = _sylvester_t(eb, X.device, X.dtype)
    if ea == 0:
        Y = torch.einsum("...b,db->...d", X, Hb)
        return (Y * scale).reshape(X.shape)
    Ha = _sylvester_t(ea, X.device, X.dtype)
    Y = X.reshape(*X.shape[:-1], A, B)
    Y = torch.einsum("...ab,ca->...cb", Y, Ha)
    Y = torch.einsum("...cb,db->...cd", Y, Hb)
    return (Y * scale).reshape(*X.shape[:-1], n)


def matmul_hadU(X: torch.Tensor, spec: HadSpec, scale=None,
                transpose: bool = False) -> torch.Tensor:
    """X @ U^T (or X @ U when transpose) along the last axis, with an
    optional extra scale; X is zero-padded to spec.padN."""
    n = X.shape[-1]
    if n != spec.padN:
        X = F.pad(X, (0, spec.padN - n))
    if spec.shards > 1:
        # block-diagonal: each shard's block on its own slice
        L = spec.padN // spec.shards
        Y = matmul_hadU(X.reshape(*X.shape[:-1], spec.shards, L),
                        spec.sub(), scale=scale, transpose=transpose)
        return Y.reshape(*X.shape[:-1], spec.padN)
    had_scale = 1.0 / math.sqrt(spec.padN // spec.K)
    if scale is not None:
        had_scale = had_scale * scale
    if spec.K == 1:
        return hadamard_transform(X, had_scale)
    hadK = _as(spec.hadK, X)
    if transpose:
        hadK = hadK.T
    M = spec.padN // spec.K
    Y = X.reshape(*X.shape[:-1], spec.K, M)
    Y = hadamard_transform(Y, had_scale)
    Y = torch.einsum("...km,jk->...jm", Y, hadK)
    return Y.reshape(*X.shape[:-1], spec.padN)


def matmul_hadUt(X: torch.Tensor, spec: HadSpec, scale=None
                 ) -> torch.Tensor:
    return matmul_hadU(X, spec, scale=scale, transpose=True)


def full_U(spec: HadSpec) -> np.ndarray:
    """Materialize U (padN x padN) — for tests and small dims only."""
    if spec.shards > 1:
        return np.kron(np.eye(spec.shards, dtype=np.float32),
                       full_U(spec.sub()))
    e = decompose_pow2(spec.padN // spec.K)[0]
    H = sylvester(e)
    hadK = (np.ones((1, 1), dtype=np.float32) if spec.hadK is None
            else np.asarray(torch.as_tensor(spec.hadK).cpu()))
    return np.kron(hadK, H) / math.sqrt(spec.padN // spec.K)


def right_b_factor(spec: HadSpec) -> Optional[Tuple[np.ndarray, int]]:
    """(H_B * had_scale, B): the low Sylvester kron factor of the RIGHT
    transform (B = 2^min(e, 7) of M = padN / K = 2^e), for the kernels'
    epilogue, which multiplies each block of B output channels by it
    (``right_b_factor`` in the JAX package). Tile-local, because B divides
    every tile and every fused segment's q_out. None when the transform
    does not factor that way: M < 8 or not a power of 2, or a
    block-diagonal transform (as in the JAX package). ``finish_right``
    applies the remaining cross-tile factors."""
    if spec.shards > 1:
        return None
    M = spec.padN // spec.K
    if M < 8 or (M & (M - 1)) != 0:
        return None
    eb = min(M.bit_length() - 1, 7)
    return sylvester(eb) / math.sqrt(M), 1 << eb


@lru_cache(maxsize=64)
def right_hb_tensor(spec_M: int, device: torch.device) -> torch.Tensor:
    """``right_b_factor``'s H_B * had_scale for M = ``spec_M`` as an f32
    (B, B) tensor on ``device``, made once (a decode step that a CUDA
    graph captures makes no copies)."""
    rb = right_b_factor(HadSpec(None, 1, spec_M))
    return torch.as_tensor(rb[0], dtype=torch.float32, device=device)


def finish_right(Y: torch.Tensor, spec: HadSpec,
                 hadK_stack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Complete a right transform whose B-side factor ran in the kernel
    epilogue (``right_b_factor``): the high Sylvester factor H_A (if any)
    and the hadK leading factor, or a stacked per-segment hadK for fused
    groups. Y: (..., [nseg,] padN), already multiplied by H_B per block."""
    M = spec.padN // spec.K
    e = M.bit_length() - 1
    eb = min(e, 7)
    ea = e - eb
    A, B = 1 << ea, 1 << eb
    lead = Y.shape[:-1]
    Y = Y.reshape(*lead, spec.K, A, B)
    if ea > 0:
        Y = torch.einsum("...kab,ca->...kcb", Y,
                         _sylvester_t(ea, Y.device, Y.dtype))
    if hadK_stack is not None:
        # (..., s, K, A, B) x (s, K', K): per-segment leading factor
        Y = torch.einsum("...skab,sjk->...sjab", Y, hadK_stack.to(Y.dtype))
    elif spec.K > 1:
        Y = torch.einsum("...kab,jk->...jab", Y, _as(spec.hadK, Y))
    return Y.reshape(*lead, spec.padN)


@lru_cache(maxsize=256)
def _grouped_hb(eb: int, had_scale: float, split: int, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """H_B with its rows permuted into the grouped lane order, pre-scaled:
    output lane l = q*(B*P/8) + c*P + j holds coefficient
    b' = 8c + (8/P)*j + q (P = split; P = 1 gives l = i*C + c, b' = 8c + i)."""
    B, P = 1 << eb, split
    ll = np.arange(B)
    qq, r = np.divmod(ll, B * P // 8)
    cc, jj = np.divmod(r, P)
    sigma = cc * 8 + (8 // P) * jj + qq
    return torch.as_tensor(sylvester(eb)[sigma] * had_scale, dtype=dtype,
                           device=device)


def matmul_hadUt_grouped(X: torch.Tensor, spec: HadSpec, Gp: int,
                         scale=None, split: int = 1
                         ) -> Optional[torch.Tensor]:
    """``matmul_hadUt`` emitted directly in the fused kernel's grouped
    layout: with P = ``split`` (1, or 2 / 4 for the sw2 / sw4 subword
    layouts) and nq = 8 / P, returns (m, 8*Gp) with

        out[:, q*(P*Gp) + P*g + j] = (X @ U)[:, 8*g + nq*j + q]  for g < G
        out[:, q*(P*Gp) + P*g + j] = 0                           for g >= G

    (G = padN // 8; at P = 1 that is out[:, i*Gp + g] = (X @ U)[:, 8g + i]).
    The permutation is free: it is a row permutation of the constant H_B
    (popcount(x & y) is invariant under a permutation of bit positions).
    A block-diagonal spec (``shards`` = s) applies its block to each of
    the s slices, the groups staying in order. Returns None when the
    power-of-2 part is < 8 (caller uses the plain transform)."""
    n = X.shape[-1]
    s, K = spec.shards, spec.K
    M = spec.padN // s // K
    if M < 8 or (M & (M - 1)) != 0 or spec.padN % 8 != 0:
        return None
    if n != spec.padN:
        X = F.pad(X, (0, spec.padN - n))
    if X.dim() != 2:
        raise ValueError("grouped prologue expects (m, n) input")
    if split not in (1, 2, 4):
        raise ValueError(f"split {split} not in (1, 2, 4)")
    m = X.shape[0]
    G = spec.padN // 8
    e = M.bit_length() - 1
    eb = min(e, 7)
    ea = e - eb
    A, B = 1 << ea, 1 << eb
    had_scale = 1.0 / math.sqrt(M)
    if scale is not None:
        had_scale = had_scale * float(scale)
    HBp = _grouped_hb(eb, had_scale, split, X.device, X.dtype)
    Y = X.reshape(m * s, K, A, B)
    if ea > 0:
        Ha = _sylvester_t(ea, X.device, X.dtype)
        Y = torch.einsum("mkab,xa->mkxb", Y, Ha)
    Y = torch.einsum("mkxb,lb->mkxl", Y, HBp)
    if K > 1:
        # hadUt: contract with hadK (not transposed): out_j = sum_k Y_k H_kj
        Y = torch.einsum("mkxl,kj->mjxl", Y, _as(spec.hadK, X))
    # lane l = (q, c, j): q out front, (s, K, A, c) group-major with j
    # minor
    P, nq = split, 8 // split
    Y = Y.reshape(m, s * K, A, nq, (B // 8) * P)
    Y = Y.permute(0, 3, 1, 2, 4).reshape(m, nq, G, P)
    if Gp != G:
        Y = F.pad(Y, (0, 0, 0, Gp - G))
    return Y.reshape(m, 8 * Gp)
