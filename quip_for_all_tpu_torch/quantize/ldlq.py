"""LDLQ: adaptive lattice rounding driven by the Hessian's block-LDL
factor — counterpart of ``quip_for_all_tpu/quantize/ldlq.py``.

The right-to-left column sweep carries the error matrix E = Wr - hatWr
(columns not yet quantized hold Wr): since the block-LDL factor L has unit
diagonal blocks and is block-lower-triangular, the reference's

    WXWX_k = Wr[:, k] + (Wr - hatWr)[:, k+1:] @ L[k+1:, k]

is E @ L[:, k], one product per step. The JAX scan becomes a loop of the
same steps on the tensors' device; every product runs in full f32
(``full_f32``: the JAX package's ``Precision.HIGHEST``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch


@contextlib.contextmanager
def full_f32():
    """f32 products in full f32 for the duration (no TF32 on the card):
    ``torch.backends.cuda.matmul.allow_tf32`` off and the float32 matmul
    precision "highest", the old values restored afterwards."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def block_ldl(L_chol: torch.Tensor, g: int) -> torch.Tensor:
    """Cholesky factor -> block-unit-lower-triangular L: each block column
    right-multiplied by the inverse of its diagonal g x g block."""
    n = L_chol.shape[0]
    if n % g:
        raise ValueError(f"{n} columns in blocks of {g}")
    m = n // g
    blocks = L_chol.reshape(m, g, m, g)
    diag = torch.einsum("igih->igh", blocks)            # (m, g, g)
    diag_inv = torch.linalg.inv(diag)
    L = torch.einsum("nmg,mgh->nmh", L_chol.reshape(n, m, g), diag_inv)
    return L.reshape(n, n)


def ldlq(Wr: torch.Tensor, Hr: torch.Tensor, L_chol: torch.Tensor, cb,
         quip_tune_iters: int = 0, on_step: Optional[Callable] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize Wr (m, n) against Hessian Hr with its Cholesky factor.

    Returns (hatWr (m, n) f32, Qidxs (m, n/codesz) int32 raw codes), on
    Wr's device. ``on_step(pass, k, X, idx)``, when given, sees every
    rounding: the pass (0 the sweep, then each tune iteration), the block
    column, the (m, codesz) rows rounded and their codes."""
    m, n = Wr.shape
    g = cb.codesz
    nb = n // g
    with full_f32():
        L = block_ldl(L_chol, g)
        # per-step block columns, contiguous: (nb, n, g)
        Lcols = L.reshape(n, nb, g).permute(1, 0, 2).contiguous()
        E = Wr.clone()
        hatW = torch.empty_like(Wr)
        Qidxs = torch.empty((m, nb), dtype=torch.int32, device=Wr.device)
        for k in range(nb - 1, -1, -1):
            cols = slice(k * g, (k + 1) * g)
            X = E @ Lcols[k]
            q, idx = cb.quantize(X)
            if on_step is not None:
                on_step(0, k, X, idx)
            E[:, cols] = Wr[:, cols] - q
            hatW[:, cols] = q
            Qidxs[:, k] = idx
        if quip_tune_iters > 0:
            # greedy coordinate-descent refinement:
            # WXWX_k = hatWr_k + (Wr - hatWr) @ Hr[:, k] @ inv(Hr[k, k]).
            # E holds Wr - hatWr throughout: a step changes only its own
            # columns, so updating them gives the elements a full
            # subtraction would
            Hcols = Hr.reshape(n, nb, g).permute(1, 0, 2).contiguous()
            Hdiag_inv = torch.linalg.inv(torch.stack(
                [Hcols[k, k * g:(k + 1) * g] for k in range(nb)]))
            for it in range(quip_tune_iters):
                for k in range(nb - 1, -1, -1):
                    cols = slice(k * g, (k + 1) * g)
                    X = hatW[:, cols] + (E @ Hcols[k]) @ Hdiag_inv[k]
                    q, idx = cb.quantize(X)
                    if on_step is not None:
                        on_step(it + 1, k, X, idx)
                    E[:, cols] = Wr[:, cols] - q
                    hatW[:, cols] = q
                    Qidxs[:, k] = idx
    return hatW, Qidxs
