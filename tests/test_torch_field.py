"""Port field arithmetic (int64 bit patterns) vs the JAX package's numpy oracle.

Tolerance: none -- integers, exact equality."""

import numpy as np
import pytest
import torch

from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.ops import goldilocks_jax as FJ
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.ops import goldilocks_torch as FT

P = int(G.P)
EDGE = np.array(
    [0, 1, P - 1, 2**32 - 1, 2**32, 2**64 - 2**32, P - 2**32, P - 2, 2, 7],
    dtype=np.uint64,
)


def _operands():
    rng = np.random.default_rng(11)
    a = np.concatenate([np.repeat(EDGE, len(EDGE)), rng.integers(0, P, 4096, dtype=np.uint64)])
    b = np.concatenate([np.tile(EDGE, len(EDGE)), rng.integers(0, P, 4096, dtype=np.uint64)])
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_oracle(op):
    a, b = _operands()
    got = FT.unpack(getattr(FT, op)(FT.pack(a), FT.pack(b)))
    assert np.array_equal(got, getattr(G, op)(a, b))


def test_binary_ops_match_jax_limbs():
    a, b = _operands()
    for op in ("add", "sub", "mul"):
        want = FJ.unpack(getattr(FJ, op)(FJ.pack(a), FJ.pack(b)))
        got = FT.unpack(getattr(FT, op)(FT.pack(a), FT.pack(b)))
        assert np.array_equal(got, want), op


def test_neg_matches_oracle():
    a, _ = _operands()
    assert np.array_equal(FT.unpack(FT.neg(FT.pack(a))), G.neg(a))


def test_mul_broadcasts_scalar():
    a, _ = _operands()
    t = FT.pack(a)
    got = FT.unpack(FT.mul(t, FT.scalar(P - 1, t)))
    assert np.array_equal(got, G.mul(a, np.uint64(P - 1)))


def test_pow_p_minus_2_is_inverse():
    rng = np.random.default_rng(12)
    a = np.concatenate([EDGE[1:], rng.integers(1, P, 1000, dtype=np.uint64)])
    assert np.array_equal(FT.unpack(FT.pow_p_minus_2(FT.pack(a))), G.inv_array(a))
    zero = FT.pack(np.zeros(3, dtype=np.uint64))
    assert np.array_equal(FT.unpack(FT.pow_p_minus_2(zero)), np.zeros(3, dtype=np.uint64))


def test_pow_p_minus_2_matches_jax():
    from sezkp_tpu.ops import ntt_jax

    rng = np.random.default_rng(13)
    a = rng.integers(0, P, 257, dtype=np.uint64)
    want = FJ.unpack(ntt_jax._pow_p_minus_2(FJ.pack(a)))
    assert np.array_equal(FT.unpack(FT.pow_p_minus_2(FT.pack(a))), want)


def test_planes_round_trip():
    a, _ = _operands()
    lo, hi = FJ.pack(a)
    t = convert.field_from_planes(np.asarray(lo), np.asarray(hi))
    assert t.dtype == torch.int64
    assert np.array_equal(FT.unpack(t), a)
    lo2, hi2 = convert.planes_from_field(t)
    assert np.array_equal(lo2, np.asarray(lo)) and np.array_equal(hi2, np.asarray(hi))
    assert np.array_equal(FT.unpack(FT.pack(a)), a)


def _pow2_operands():
    """Random canonical operands with 0, 1, 2^32, 2^63 and p - 1 planted."""
    rng = np.random.default_rng(14)
    edge = np.array([0, 1, 2**32, 2**63, P - 1], dtype=np.uint64)
    return np.concatenate([edge, rng.integers(0, P, 59, dtype=np.uint64)])


@pytest.mark.parametrize("lo", [0, 48, 96, 144])
def test_mul_pow2_matches_mul_and_jax(lo):
    """FT.mul_pow2(x, e) == FT.mul(x, 2^e mod p) == the JAX package's FJ.mul
    for every e in [lo, lo + 48): the four quarters of 0 .. 191 cover the
    three shift ranges of the fold and the negated half (e >= 96)."""
    x = _pow2_operands()
    es = np.arange(lo, lo + 48)
    pw = np.array([pow(2, int(e), P) for e in es], dtype=np.uint64)
    xs = np.broadcast_to(x[None, :], (len(es), len(x))).copy()
    ws = np.broadcast_to(pw[:, None], xs.shape).copy()
    want = FJ.unpack(FJ.mul(FJ.pack(xs), FJ.pack(ws)))
    assert np.array_equal(FT.unpack(FT.mul(FT.pack(xs), FT.pack(ws))), want)
    # one int exponent at a time, and every exponent at once as a tensor
    for i, e in enumerate(es):
        assert np.array_equal(FT.unpack(FT.mul_pow2(FT.pack(x), int(e))), want[i]), int(e)
    got = FT.mul_pow2(FT.pack(xs), torch.as_tensor(es, dtype=torch.int64)[:, None])
    assert np.array_equal(FT.unpack(got), want)


def test_bfly_is_add_and_sub():
    """FT.bfly (the butterfly's sum as u - (p - t)) == (add, sub), and the
    oracle's, on the edge values both ways round."""
    a, b = _operands()
    s, d = FT.bfly(FT.pack(a), FT.pack(b))
    assert np.array_equal(FT.unpack(s), G.add(a, b)) and np.array_equal(FT.unpack(d), G.sub(a, b))
    s, d = FT.bfly(FT.pack(b), FT.pack(a))
    assert np.array_equal(FT.unpack(s), G.add(b, a)) and np.array_equal(FT.unpack(d), G.sub(b, a))


def test_neg_edges():
    x = _pow2_operands()
    assert np.array_equal(FT.unpack(FT.neg(FT.pack(x))), G.neg(x))
    assert np.array_equal(FT.unpack(FT.add(FT.neg(FT.pack(x)), FT.pack(x))), np.zeros_like(x))
