"""Hadamard matrix tables: the reference's exact matrices + Paley generation.

A copy of ``quip_for_all_tpu/transforms/hadamard_tables.py`` with its own
copy of the asset, so the PyTorch port imports nothing of the JAX package.

The reference ships a binary asset ``hadamard.safetensors`` (34 matrices of
orders {1,2,4} ∪ {12,20,...,252}, loaded at the reference's ``quant.py:8``)
and uses those EXACT matrices for the ``use_rand=False`` incoherence
transform; since the factors are recomputed from the table at checkpoint
load (not stored), bit-identical tables are required to decode
reference-produced ``use_rand=False`` checkpoints. We embed the same 34
matrices as packed sign bits (``_hadamard_asset.npz``, ~36 KB; bit = 1 means
−1) — ``hadamard_matrix`` serves them and is the interop path.

``generated_hadamard_matrix`` additionally constructs Hadamard matrices from
scratch — Paley I (n = q+1, q ≡ 3 mod 4 a prime power), Paley II
(n = 2(q+1), q ≡ 1 mod 4 a prime power), and Sylvester doubling — used only
as a fallback for orders outside the table (> 252) and as an independent
cross-check in tests. Orders {92, 116, 156, 172, 188, 236} need
Williamson-type constructions and are only available from the table.
"""
from __future__ import annotations

import os
from functools import lru_cache
from itertools import product
from typing import Dict, List, Optional, Tuple

import numpy as np

_ASSET_PATH = os.path.join(os.path.dirname(__file__), "_hadamard_asset.npz")


def _factor_prime_power(q: int) -> Optional[Tuple[int, int]]:
    if q < 2:
        return None
    for p in range(2, int(q ** 0.5) + 1):
        if q % p == 0:
            k = 0
            while q % p == 0:
                q //= p
                k += 1
            return (p, k) if q == 1 else None
    return (q, 1)


def _gf_elements(p: int, k: int) -> Tuple[List[Tuple[int, ...]], dict]:
    """GF(p^k) as coefficient tuples, plus a multiplication table.

    Finds an irreducible monic polynomial of degree k over GF(p) by brute
    force, then builds products by polynomial multiplication mod it.
    """
    if k == 1:
        elems = [(i,) for i in range(p)]
        mul = {(a, b): ((a[0] * b[0]) % p,) for a in elems for b in elems}
        return elems, mul

    def polymul(a, b):
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
        return out

    def polymod(a, m):
        a = list(a)
        dm = len(m) - 1
        while len(a) > dm:
            lead = a[-1]
            if lead:
                shift = len(a) - 1 - dm
                for i, mi in enumerate(m):
                    a[shift + i] = (a[shift + i] - lead * mi) % p
            a.pop()
        return tuple(a + [0] * (dm - len(a)))

    # find irreducible monic poly: no element of GF(p^j), j<k, is a root and
    # it has no monic factor of degree <= k//2 (trial division).
    def is_irreducible(m):
        monics = [[1]]
        for deg in range(1, k // 2 + 1):
            cands = [list(c) + [1] for c in product(range(p), repeat=deg)]
            for c in cands:
                # divide m by c, check remainder
                r = list(m)
                while len(r) >= len(c) and any(r):
                    lead = r[-1]
                    if lead:
                        # c is monic
                        shift = len(r) - len(c)
                        for i, ci in enumerate(c):
                            r[shift + i] = (r[shift + i] - lead * ci) % p
                    r.pop()
                if not any(r):
                    return False
        return True

    modpoly = None
    for tail in product(range(p), repeat=k):
        cand = list(tail) + [1]
        if cand[0] != 0 and is_irreducible(cand):
            modpoly = cand
            break
    assert modpoly is not None

    elems = [tuple(c) for c in product(range(p), repeat=k)]
    mul = {}
    for a in elems:
        for b in elems:
            mul[(a, b)] = polymod(polymul(list(a), list(b)), modpoly)
    return elems, mul


@lru_cache(maxsize=None)
def _jacobsthal(q: int) -> np.ndarray:
    """Q[i,j] = chi(e_i - e_j) over GF(q), chi the quadratic character."""
    p, k = _factor_prime_power(q)
    elems, mul = _gf_elements(p, k)
    idx = {e: i for i, e in enumerate(elems)}
    zero = elems[0 if k == 1 else elems.index(tuple([0] * k))]
    squares = {mul[(e, e)] for e in elems if e != zero}
    chi = np.zeros(q)
    for e in elems:
        if e == zero:
            continue
        chi[idx[e]] = 1.0 if e in squares else -1.0
    Q = np.zeros((q, q))
    for i, a in enumerate(elems):
        for j, b in enumerate(elems):
            diff = tuple((x - y) % p for x, y in zip(a, b))
            Q[i, j] = chi[idx[diff]]
    return Q


def _paley_1(q: int) -> np.ndarray:
    """Order q+1, q prime power ≡ 3 (mod 4): H = I + C, C skew."""
    Q = _jacobsthal(q)
    n = q + 1
    C = np.zeros((n, n))
    C[0, 1:] = 1.0
    C[1:, 0] = -1.0
    C[1:, 1:] = Q
    return np.eye(n) + C


def _paley_2(q: int) -> np.ndarray:
    """Order 2(q+1), q prime power ≡ 1 (mod 4)."""
    Q = _jacobsthal(q)
    m = q + 1
    S = np.zeros((m, m))
    S[0, 1:] = 1.0
    S[1:, 0] = 1.0
    S[1:, 1:] = Q
    A = np.array([[1.0, 1.0], [1.0, -1.0]])
    B = np.array([[1.0, -1.0], [-1.0, -1.0]])
    return np.kron(S, A) + np.kron(np.eye(m), B)


@lru_cache(maxsize=None)
def _asset_tables() -> Dict[int, np.ndarray]:
    """The reference's hadamard.safetensors matrices, from packed sign bits."""
    if not os.path.isfile(_ASSET_PATH):
        return {}
    out = {}
    with np.load(_ASSET_PATH) as z:
        for key in z.files:
            n = int(key[1:])
            bits = np.unpackbits(z[key])[: n * n].reshape(n, n)
            out[n] = (1.0 - 2.0 * bits).astype(np.float64)
    return out


@lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> Optional[np.ndarray]:
    """A ±1 Hadamard matrix of order n, or None if unavailable.

    Returns the reference-identical table matrix when the order is in the
    embedded asset (required for ``use_rand=False`` checkpoint interop,
    the reference's ``quant.py:36-39``), else falls back to an
    independently generated one.
    """
    tbl = _asset_tables().get(n)
    if tbl is not None:
        return tbl
    return generated_hadamard_matrix(n)


@lru_cache(maxsize=None)
def generated_hadamard_matrix(n: int) -> Optional[np.ndarray]:
    """Construct a ±1 Hadamard matrix of order n from scratch (Paley I/II +
    Sylvester doubling), or None if no construction applies."""
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        return np.array([[1.0, 1.0], [1.0, -1.0]])
    if n % 4 != 0:
        return None
    fp = _factor_prime_power(n - 1)
    if fp is not None and (n - 1) % 4 == 3:
        return _paley_1(n - 1)
    if n % 2 == 0:
        q = n // 2 - 1
        fp = _factor_prime_power(q)
        if fp is not None and q % 4 == 1:
            return _paley_2(q)
    if n % 2 == 0:
        half = generated_hadamard_matrix(n // 2)
        if half is not None:
            return np.kron(np.array([[1.0, 1.0], [1.0, -1.0]]), half)
    return None


def available(n: int) -> bool:
    return hadamard_matrix(n) is not None
