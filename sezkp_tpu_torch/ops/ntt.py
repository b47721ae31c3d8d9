"""Radix-2 NTT/INTT over Goldilocks (host numpy path), plus coset LDE helpers.

Math semantics match the reference (crates/sezkp-ffts/src/ntt.rs): the forward
transform maps coefficients -> evaluations in natural order, y_k = sum_j a_j
w^(jk) with w = 7^((p-1)/n); the inverse mirrors it and scales by n^-1.
The reference's per-butterfly loops become whole-array vectorized stages
(reshape into [n/len, 2, half] blocks, one mulmod/addmod per stage).

The device path with identical outputs lives in
:mod:`sezkp_tpu_torch.ops.ntt_torch`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np

from . import goldilocks as G

__all__ = [
    "forward_ntt",
    "inverse_ntt",
    "evaluate_on_pow2_domain",
    "interpolate_from_evals",
    "evaluate_on_coset_pow2",
    "naive_dft",
    "twiddle_tables",
    "bitrev_permutation",
    "powers",
]


@lru_cache(maxsize=64)
def bitrev_permutation(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for _ in range(bits):
        rev = (rev << np.uint64(1)) | (idx & np.uint64(1))
        idx >>= np.uint64(1)
    return rev.astype(np.int64)


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as uint64 (log-doubling build)."""
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    out[0] = 1
    m = 1
    b = np.uint64(base % int(G.P))
    cur = b
    while m < n:
        take = min(m, n - m)
        out[m : m + take] = G.mul(out[:take], cur)
        m += take
        cur = G.mul(cur, cur) if m < n else cur
    # note: cur tracks base^(2^k); G.mul broadcast keeps this O(n) total
    return out


def _powers_simple(base: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    acc = np.uint64(1)
    b = np.uint64(base % int(G.P))
    for i in range(n):
        out[i] = acc
        acc = G.mul(acc, b)
    return out


@lru_cache(maxsize=64)
def twiddle_tables(n_log2: int, inverse: bool) -> tuple:
    """Per-stage twiddle tables; stage s has 2^(s-1) entries (ffts/ntt.rs:43-75)."""
    tables: List[np.ndarray] = []
    for s in range(1, n_log2 + 1):
        half = 1 << (s - 1)
        w = G.primitive_root_2exp(s)
        if inverse:
            w = G.inv(w)
        tables.append(powers(w, half))
    return tuple(tables)


def _ntt_core(a: np.ndarray, tables) -> np.ndarray:
    n = a.shape[0]
    a = a[bitrev_permutation(n)]
    n_log2 = n.bit_length() - 1
    for s in range(1, n_log2 + 1):
        half = 1 << (s - 1)
        blk = a.reshape(n >> s, 2, half)
        u = blk[:, 0, :]
        v = G.mul(blk[:, 1, :], tables[s - 1][None, :])
        a = np.concatenate([G.add(u, v)[:, None, :], G.sub(u, v)[:, None, :]], axis=1)
        a = a.reshape(n)
    return a


def forward_ntt(a: np.ndarray) -> np.ndarray:
    """Coefficients -> evaluations (natural order). len power of two."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    n = a.shape[0]
    if n <= 1:
        return a.copy()
    assert n & (n - 1) == 0, "NTT size must be power of two"
    return _ntt_core(a, twiddle_tables(n.bit_length() - 1, False))


def inverse_ntt(a: np.ndarray) -> np.ndarray:
    """Evaluations -> coefficients; scales by n^-1."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    n = a.shape[0]
    if n <= 1:
        return a.copy()
    assert n & (n - 1) == 0, "NTT size must be power of two"
    out = _ntt_core(a, twiddle_tables(n.bit_length() - 1, True))
    inv_n = np.uint64(G.inv(n))
    return G.mul(out, inv_n)


def evaluate_on_pow2_domain(coeffs: np.ndarray, k_log2: int) -> np.ndarray:
    """Zero-pad/truncate to 2^k then forward NTT (ffts/ntt.rs:162-170)."""
    n = 1 << k_log2
    buf = np.zeros(n, dtype=np.uint64)
    m = min(len(coeffs), n)
    buf[:m] = coeffs[:m]
    return forward_ntt(buf)


def interpolate_from_evals(evals: np.ndarray) -> np.ndarray:
    return inverse_ntt(np.asarray(evals, dtype=np.uint64))


def evaluate_on_coset_pow2(coeffs: np.ndarray, k_log2: int, shift: int) -> np.ndarray:
    """NTT of shift^j-scaled coefficients (ffts/coset.rs:85-102)."""
    n = 1 << k_log2
    m = min(len(coeffs), n)
    scaled = np.zeros(n, dtype=np.uint64)
    scaled[:m] = G.mul(np.asarray(coeffs[:m], dtype=np.uint64), powers(shift, m))
    return forward_ntt(scaled)


def naive_dft(a: np.ndarray, omega: int) -> np.ndarray:
    """O(n^2) DFT for testing (ffts/lib.rs:189-205)."""
    a = np.asarray(a, dtype=np.uint64)
    n = len(a)
    ws = powers(omega, n)
    out = np.zeros(n, dtype=np.uint64)
    for k in range(n):
        # w^(jk) for j in range(n)
        wk = ws[(np.arange(n) * k) % n]
        out[k] = _sum_mod(G.mul(a, wk))
    return out


def _sum_mod(a: np.ndarray) -> np.uint64:
    return np.uint64(int(np.sum(a.astype(object))) % int(G.P))
