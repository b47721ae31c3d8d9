"""Goldilocks arithmetic on torch tensors, one int64 per field element.

Device representation of the port (decided once, here): a field element is
one ``torch.int64`` holding the u64 bit pattern of the canonical value
(< p = 2^64 - 2^32 + 1). The CUDA kernels read the same memory as
``uint64_t*``. The JAX package keeps two uint32 planes ``(lo, hi)`` instead
(ops/goldilocks_jax.py) because its target has no 64-bit integers;
``planes_to_field`` / ``field_to_planes`` convert between the two so tests
can feed both packages the same numbers.

torch has no unsigned 64-bit arithmetic, so the plain ops below work on the
signed bit pattern:

- ``+``, ``-``, ``*`` on int64 wrap mod 2^64, which is what u64 does;
- ``>>`` is arithmetic, so every right shift is masked afterwards;
- unsigned ``a < b`` is ``(a ^ MIN) < (b ^ MIN)`` (sign-bias trick);
- the 64x64 -> 128 product is built from four 32x32 partial products (each
  exact in 64 bits) with explicit carries, then reduced with
  2^64 = 2^32 - 1 and 2^96 = -1 (mod p).

All functions are elementwise over broadcastable shapes, run on whatever
device the tensors lie on, and always return canonical values.
Cross-tested against :mod:`sezkp_tpu_torch.ops.goldilocks` (numpy/u64 oracle).
"""

from __future__ import annotations

import numpy as np
import torch

P_INT = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF  # 2^64 mod p = 2^32 - 1
_P_I64 = P_INT - (1 << 64)  # bit pattern of p as a signed int64 (= 1 - 2^32)
_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF


def _i64(v: int) -> int:
    """Python int in [0, 2^64) -> the signed int with the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def pack(x, device=None) -> torch.Tensor:
    """numpy uint64 array (or int) -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    t = torch.from_numpy(a.view(np.int64).copy())
    return t if device is None else t.to(device)


def unpack(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def planes_to_field(lo, hi, device=None) -> torch.Tensor:
    """(lo, hi) uint32 planes (numpy) -> int64 field tensor."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return pack(lo | (hi << np.uint64(32)), device)


def field_to_planes(t: torch.Tensor):
    """int64 field tensor -> (lo, hi) uint32 numpy planes."""
    v = unpack(t)
    return (
        (v & np.uint64(_M32)).astype(np.uint32),
        (v >> np.uint64(32)).astype(np.uint32),
    )


def scalar(v: int, like: torch.Tensor) -> torch.Tensor:
    """0-d field constant on `like`'s device."""
    return torch.tensor(_i64(int(v) % P_INT), dtype=torch.int64, device=like.device)


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _MIN) < (b ^ _MIN)


def _ge_p(x):
    """Unsigned x >= p: the bit patterns p .. 2^64-1 are the signed values
    1 - 2^32 .. -1."""
    return (x < 0) & (x >= _P_I64)


def _canon(x):
    return torch.where(_ge_p(x), x - _P_I64, x)


def add(a, b):
    s = a + b
    # carry out of 2^64: fold it back as +EPS (cannot carry twice: a, b < p)
    s = torch.where(_ult(s, a), s + EPS, s)
    return _canon(s)


def sub(a, b):
    """a - b; right for a < 2^64 and b <= p where the difference is one of
    field elements (a - b >= -p)."""
    d = a - b
    # borrow: the wrapped value is a - b + 2^64; take EPS off to get a - b + p
    return torch.where(_ult(a, b), d - EPS, d)


def neg(a):
    return torch.where(a == 0, a, _P_I64 - a)


def _srl32(x):
    return (x >> 32) & _M32


def mul(a, b):
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a & _M32, _srl32(a)
    b0, b1 = b & _M32, _srl32(b)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    # 128-bit product (hi, lo) with explicit carries
    mid = lh + hl
    c_mid = _ult(mid, lh).to(torch.int64)
    lo = ll + (mid << 32)
    c_lo = _ult(lo, ll).to(torch.int64)
    hi = hh + _srl32(mid) + (c_mid << 32) + c_lo
    # reduce: hi = hh1 * 2^32 + hh0;  2^64 = EPS, 2^96 = -1
    hh0 = hi & _M32
    hh1 = _srl32(hi)
    t0 = lo - hh1
    t0 = torch.where(_ult(lo, hh1), t0 - EPS, t0)
    t1 = hh0 * EPS
    r = t0 + t1
    r = torch.where(_ult(r, t1), r + EPS, r)
    return _canon(r)


def _srl(x, k):
    """Logical right shift of int64 bit patterns by k in 1..63 (int or tensor)."""
    return (x >> k) & ((torch.ones_like(x) << (64 - k)) - 1)


def mul_pow2(x, e):
    """x * 2^e mod p for 0 <= e < 192 (int or tensor, broadcast with x), from
    shifts alone: line for line the plain version of ``gl::mul_pow2``
    (csrc/goldilocks.cuh). 2^96 = -1, so e >= 96 is the negative of
    x * 2^(e - 96); with s = e mod 96, N = x * 2^s < 2^160 splits into
    n0 (bits 0..63), n1 (64..95), n2 (96..159) and
    N = n0 + n1 * EPS - n2 (mod p). Shift counts are clamped into range where
    a branch does not use them."""
    e = torch.as_tensor(e, dtype=torch.int64, device=x.device)
    x, e = torch.broadcast_tensors(x, e)
    negate = e >= 96
    s = torch.where(negate, e - 96, e)
    lt64 = s < 64
    zero = torch.zeros_like(x)
    n0 = torch.where(s == 0, x, torch.where(lt64, x << s.clamp(max=63), zero))
    n1 = torch.where(
        s == 0, zero,
        torch.where(lt64, _srl(x, (64 - s).clamp(1, 63)), x << (s - 64).clamp(0, 31)) & _M32,
    )
    n2 = torch.where(s > 32, _srl(x, (96 - s).clamp(1, 63)), zero)
    t0 = sub(n0, n2)
    t1 = (n1 << 32) - n1
    r = t0 + t1
    r = torch.where(_ult(r, t1), r + EPS, r)
    r = _canon(r)
    return torch.where(negate, neg(r), r)


def bfly(u, t):
    """(u + t, u - t), the plain version of ``gl::bfly``: the sum as
    u - (p - t), a borrow adding p back, as ``sub`` does (b = p when t = 0)."""
    return sub(u, _P_I64 - t), sub(u, t)


def pow_p_minus_2(x):
    """x^(p-2) elementwise (Fermat inverse; 0 -> 0): 64 squarings and the
    multiplies of the set exponent bits, all plain tensor ops."""
    e = P_INT - 2
    acc = torch.ones_like(x)
    base = x
    for i in range(64):
        if (e >> i) & 1:
            acc = mul(acc, base)
        if i < 63:
            base = mul(base, base)
    return acc
