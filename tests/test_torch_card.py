"""Hand-written kernels on the card against their plain versions, for kernels
that the CPU cannot run (CUDA has no interpret mode): K12 deep_divide.

Every test here is marked ``card`` and skips without a CUDA device. On a
machine with an H100 (nvcc builds the kernels at first use):

    python -m pytest tests/test_torch_card.py -q

This file imports no JAX: the card's machine has none.

Tolerance: none -- field elements, exact equality."""

import numpy as np
import pytest
import torch

from sezkp_tpu_torch.ops import goldilocks as G
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt_torch as NT
from sezkp_tpu_torch.stark.v1.prover import _deep_lde_host, _nudge_off_coset

pytestmark = pytest.mark.card

P = int(G.P)
SHIFT, BLOW_LOG2 = 3, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K12 runs only on the card")
    return torch.device("cuda")


def _field(n, seed, device):
    a = np.random.default_rng(seed).integers(0, P, n, dtype=np.uint64)
    a[: min(n, 4)] = [0, 1, 1 << 32, P - 1][: min(n, 4)]
    return FT.pack(a, device)


@pytest.mark.parametrize("n_log2,extra", [(13, 3), (20, 0), (23, 0)])
def test_deep_divide_kernel_equals_plain(card, n_log2, extra):
    """K12 == deep_divide_plain on the same CUDA tensors: at 2^13 + 3 random
    points, and at 2^20 and 2^23 over the LDE's coset; z off the coset (as
    the prover nudges it) and z on it (a zero denominator, 0 there); one
    launch a call."""
    n = (1 << n_log2) + extra
    y = _field(n, 1500 + n_log2, card)
    if extra:
        xs = _field(n, 1600 + n_log2, card)
        xs[n // 2] = xs[7]
    else:
        xs = NT._deep_lde_tables(n_log2 - BLOW_LOG2, n_log2, SHIFT, card)[1]
    z_off = _nudge_off_coset(0x1234567890ABCDEF % P, SHIFT, n_log2)
    z_on = int(FT.unpack(xs[7:8])[0])
    for z in (z_off, z_on):
        before = NT.deep_divide.launches
        got = NT.deep_divide(y, z, xs)
        assert NT.deep_divide.launches == before + 1
        want = NT.deep_divide_plain(y, z, xs)
        assert torch.equal(got, want), (n, z)
    assert int(got[7]) == 0 and bool((got != 0).sum() >= n - 4)


def test_deep_coset_lde_on_card_equals_host(card):
    """The DEEP coset LDE of 2^13 base rows on the card (K5, K2-K4, K12) ==
    the host's _deep_lde_host, with one K12 launch."""
    base = np.random.default_rng(1700).integers(0, P, 1 << 13, dtype=np.uint64)
    z = _nudge_off_coset(0xFEDCBA9876543210 % P, SHIFT, 13 + BLOW_LOG2)
    before = NT.deep_divide.launches
    got = NT.deep_coset_lde_u64(base, BLOW_LOG2, SHIFT, z, card)
    assert NT.deep_divide.launches == before + 1
    assert np.array_equal(got, _deep_lde_host(base, BLOW_LOG2, SHIFT, z))


def test_deep_divide_refuses_what_the_kernel_does_not_take(card):
    y = _field(64, 1800, card)
    for xs in (y[:32], y.view(8, 8).t(), y.to(torch.int32), y.cpu()):
        with pytest.raises(ValueError):
            NT.deep_divide(y if xs.dim() == 1 else y.view(8, 8), 5, xs)
