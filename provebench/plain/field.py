"""The Goldilocks field, p = 2^64 - 2^32 + 1, in int64 tensors.

An element is its canonical residue, 0 <= x < p, held in an int64 as the
same 64 bits (so values from 2^63 up read as negative). Products are formed
from 32-bit halves and reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
The NTT is the textbook iterative radix-2 transform: bit-reversed input,
log2(n) butterfly stages, natural-order output, y_i = sum_j a_j w^(i j)
with w = 7^((p - 1) / n).
"""

from __future__ import annotations

import torch

P = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF               # 2^64 mod p
M32 = 0xFFFFFFFF
SIGN = -(1 << 63)
GENERATOR = 7


def signed(x: int) -> int:
    """The int64 that holds the 64 bits of 0 <= x < 2^64."""
    return x - (1 << 64) if x >= 1 << 63 else x


def unsigned(x: int) -> int:
    return x & 0xFFFFFFFFFFFFFFFF


def const(x: int, device) -> torch.Tensor:
    return torch.tensor(signed(x % P), dtype=torch.int64, device=device)


def _lt(a: torch.Tensor, b) -> torch.Tensor:
    """a < b as unsigned 64-bit numbers."""
    return (a ^ SIGN) < (b ^ SIGN)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def canon(x: torch.Tensor) -> torch.Tensor:
    """x mod p for any 64-bit x (one subtraction is enough)."""
    return torch.where(_lt(x, signed(P)), x, x - signed(P))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    s = torch.where(_lt(s, a), s + EPS, s)   # a carry out of 2^64 is worth EPS
    return canon(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(_lt(a, b), d - EPS, d)  # a borrow of 2^64 is worth -EPS


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1 = a & M32, shr(a, 32)
    b0, b1 = b & M32, shr(b, 32)
    lo, hi = a0 * b0, a1 * b1
    m1, m2 = a0 * b1, a1 * b0
    # the 128-bit product hi:lo, with the two middle terms added at bit 32
    mid = m1 + m2
    mid_carry = _lt(mid, m1).to(torch.int64) << 32
    lo2 = lo + (mid << 32)
    hi = hi + shr(mid, 32) + mid_carry + _lt(lo2, lo).to(torch.int64)
    lo = lo2
    # hi = h1 * 2^32 + h0: x = lo + h0 * (2^32 - 1) - h1 (mod p)
    h0, h1 = hi & M32, shr(hi, 32)
    t = lo - h1
    t = torch.where(_lt(lo, h1), t - EPS, t)
    u = (h0 << 32) - h0
    s = t + u
    s = torch.where(_lt(s, t), s + EPS, s)
    return canon(s)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p - 2): the inverse of each nonzero element."""
    e = P - 2
    result = torch.full_like(a, 1)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


# ------------------------------------------------------------ scalars


def pow_int(x: int, e: int) -> int:
    return pow(x % P, e, P)


def inv_int(x: int) -> int:
    return pow(x % P, P - 2, P)


def root_of_unity(k: int) -> int:
    """A generator of the 2^k-th roots of unity, 7^((p - 1) / 2^k)."""
    assert 0 <= k <= 32
    return pow_int(GENERATOR, (P - 1) >> k)


# ------------------------------------------------------------ vectors


def from_i64(x: torch.Tensor) -> torch.Tensor:
    """Small signed integers as field elements (-1 -> p - 1)."""
    x = x.to(torch.int64)
    return torch.where(x < 0, x + signed(P), x)


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)], doubling the known prefix."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    out[0] = 1
    m = 1
    while m < n:
        take = min(m, n - m)
        out[m:m + take] = mul(out[:take], const(pow_int(base, m), device))
        m += take
    return out


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def _ntt(a: torch.Tensor, w_of_stage) -> torch.Tensor:
    n = a.shape[0]
    a = a[_bit_reverse(n, a.device)]
    for s in range(1, n.bit_length()):
        half = 1 << (s - 1)
        tw = powers(w_of_stage(s), half, a.device)
        blk = a.view(n >> s, 2, half)
        u, v = blk[:, 0], mul(blk[:, 1], tw)
        a = torch.stack([add(u, v), sub(u, v)], dim=1).reshape(n)
    return a


def ntt(a: torch.Tensor) -> torch.Tensor:
    """Coefficients -> values at w^0 .. w^(n-1), w of order n."""
    return _ntt(a, root_of_unity)


def intt(a: torch.Tensor) -> torch.Tensor:
    """Values at w^0 .. w^(n-1) -> coefficients."""
    n = a.shape[0]
    out = _ntt(a, lambda s: inv_int(root_of_unity(s)))
    return mul(out, const(inv_int(n), a.device))


def to_le_bytes(x: int) -> bytes:
    return unsigned(x).to_bytes(8, "little")
