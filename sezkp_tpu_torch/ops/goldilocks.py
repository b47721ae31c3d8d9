"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic, vectorized.

Host reference implementation over numpy uint64 arrays. Exactness: products
are computed via 32-bit limb splits (32x32->64 fits uint64), then reduced with
the Goldilocks identity 2^64 === 2^32 - 1 (mod p). Semantics match the
reference `Fp64<GOLDILOCKS>` (crates/sezkp-ffts/src/lib.rs:33-187): canonical
representatives in [0, p), `from_i64` maps two's-complement via rem_euclid,
inverse via pow(p-2).

The device path (one int64 tensor holding the u64 bit pattern) lives in
:mod:`sezkp_tpu_torch.ops.goldilocks_torch`; both are cross-tested.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "P",
    "EPS",
    "add",
    "sub",
    "neg",
    "mul",
    "pow_scalar",
    "inv",
    "inv_array",
    "from_i64",
    "to_le_bytes",
    "from_le_bytes",
    "primitive_root_2exp",
]

P = np.uint64(0xFFFFFFFF00000001)
_P_INT = 0xFFFFFFFF00000001
EPS = np.uint64(0xFFFFFFFF)  # 2^32 - 1 === 2^64 mod p
_M32 = np.uint64(0xFFFFFFFF)

_ERRSTATE = {"over": "ignore"}


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


def add(a, b) -> np.ndarray:
    a, b = _u64(a), _u64(b)
    with np.errstate(**_ERRSTATE):
        s = a + b  # wraps mod 2^64
        carry = s < a
        # + 2^64 === + EPS
        s = np.where(carry, s + EPS, s)  # cannot re-wrap: s < p on carry path
        s = np.where(s >= P, s - P, s)
    return s


def sub(a, b) -> np.ndarray:
    a, b = _u64(a), _u64(b)
    with np.errstate(**_ERRSTATE):
        d = a - b
        borrow = a < b
        d = np.where(borrow, d - EPS, d)  # - 2^64 === - EPS
        d = np.where(d >= P, d - P, d)  # handles the borrow-path wrap
    return d


def neg(a) -> np.ndarray:
    a = _u64(a)
    return np.where(a == 0, a, P - a)


def mul(a, b) -> np.ndarray:
    """Modular multiply via 32-bit limb split + Goldilocks fold."""
    a, b = _u64(a), _u64(b)
    with np.errstate(**_ERRSTATE):
        a0 = a & _M32
        a1 = a >> np.uint64(32)
        b0 = b & _M32
        b1 = b >> np.uint64(32)

        ll = a0 * b0  # < 2^64
        lh = a0 * b1
        hl = a1 * b0
        hh = a1 * b1

        # 128-bit product = ll + (lh + hl) << 32 + hh << 64
        mid = lh + (ll >> np.uint64(32))
        mid2 = mid + hl
        carry_mid = np.where(mid2 < hl, np.uint64(1), np.uint64(0))

        lo = (ll & _M32) | (mid2 << np.uint64(32))
        hi = hh + (mid2 >> np.uint64(32)) + (carry_mid << np.uint64(32))

        # reduce: x = lo + hi * 2^64; 2^64 === EPS
        # hi = hi_hi * 2^32 + hi_lo ; 2^96 === -1, so x === lo - hi_hi + hi_lo*EPS
        hi_hi = hi >> np.uint64(32)
        hi_lo = hi & _M32

        t = lo - hi_hi
        borrow = lo < hi_hi
        t = np.where(borrow, t - EPS, t)  # t - 2^64 === t - EPS (adds p back)

        t2 = t + hi_lo * EPS  # hi_lo*EPS < 2^64
        carry = t2 < t
        t2 = np.where(carry, t2 + EPS, t2)
        t2 = np.where(t2 >= P, t2 - P, t2)
    return t2


def pow_scalar(base: int, e: int) -> int:
    """Scalar exponentiation (Python ints; used for twiddle/setup only)."""
    return pow(int(base), int(e), _P_INT)


def inv(x: int) -> int:
    x = int(x) % _P_INT
    if x == 0:
        raise ZeroDivisionError("inverse of zero in Goldilocks")
    return pow(x, _P_INT - 2, _P_INT)


def _scan_prod_exclusive(a: np.ndarray) -> np.ndarray:
    """Exclusive prefix products via log-doubling (O(log n) vector passes)."""
    n = a.shape[0]
    pref = np.empty(n, dtype=np.uint64)
    pref[0] = 1
    pref[1:] = a[:-1]
    shift = 1
    while shift < n:
        nxt = pref.copy()
        nxt[shift:] = mul(pref[shift:], pref[:-shift])
        pref = nxt
        shift <<= 1
    return pref


def inv_array(a) -> np.ndarray:
    """Batch inversion: 1/a[i] = prefix_excl[i] * suffix_excl[i] * inv(total).

    One scalar Fermat inversion + O(log n) vectorized multiply passes."""
    a = _u64(a).ravel()
    n = a.shape[0]
    if n == 0:
        return a
    pre = _scan_prod_exclusive(a)
    suf = _scan_prod_exclusive(a[::-1])[::-1]
    total = mul(pre[-1], a[-1])
    total_inv = np.uint64(inv(int(total)))
    return mul(mul(pre, suf), total_inv)


def from_i64(x) -> np.ndarray:
    """Two's-complement i64 -> field (rem_euclid semantics)."""
    x = np.asarray(x, dtype=np.int64)
    with np.errstate(**_ERRSTATE):
        nonneg = x >= 0
        pos = x.astype(np.uint64) % P
        m = (np.negative(x)).astype(np.uint64) % P
        negv = np.where(m == 0, np.uint64(0), P - m)
    return np.where(nonneg, pos, negv)


def to_le_bytes(a) -> np.ndarray:
    """uint64 array -> uint8 [..., 8] little-endian."""
    a = np.ascontiguousarray(_u64(a), dtype="<u8")
    return a.view(np.uint8).reshape(a.shape + (8,))


def from_le_bytes(b: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(b, dtype=np.uint8)
    return b.reshape(b.shape[:-1] + (8,)).view("<u8").reshape(b.shape[:-1])


def primitive_root_2exp(k: int) -> int:
    """omega_k = 7^((p-1)/2^k), 2-adicity 32 (reference: ffts/lib.rs:236-242)."""
    assert 0 <= k <= 32, "k too large for Goldilocks 2-adicity"
    return pow_scalar(7, (_P_INT - 1) >> k)
