"""Hand-written kernels on the card against their plain versions, for kernels
that the CPU cannot run (CUDA has no interpret mode): K12 deep_divide and
K13 blake3_chunk_roots.

Every test here is marked ``card`` and skips without a CUDA device. On a
machine with an H100 (nvcc builds the kernels at first use):

    python -m pytest tests/test_torch_card.py -q

This file imports no JAX: the card's machine has none.

Tolerance: none -- field elements, exact equality."""

import numpy as np
import pytest
import torch

from sezkp_tpu_torch.ops import blake3_torch as BT
from sezkp_tpu_torch.ops import goldilocks as G
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt_torch as NT
from sezkp_tpu_torch.stark.v1.columns import all_labels
from sezkp_tpu_torch.stark.v1.openings import _label_prefix
from sezkp_tpu_torch.stark.v1.prover import _deep_lde_host, _nudge_off_coset
from sezkp_tpu_torch.utils import tracing

pytestmark = pytest.mark.card

P = int(G.P)
SHIFT, BLOW_LOG2 = 3, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K12 and K13 run only on the card")
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


# ----------------------------- K13 blake3_chunk_roots -----------------------

LABELS = [_label_prefix(lb) for lb in all_labels(8)]


def _bits(rows, n, seed, device):
    """int64 [rows, n] of random 64-bit patterns, made on the card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    hi = torch.randint(0, 1 << 32, (rows, n), generator=gen, device=device, dtype=torch.int64)
    return (hi << 32) | torch.randint(0, 1 << 32, (rows, n), generator=gen, device=device,
                                      dtype=torch.int64)


@pytest.mark.parametrize("shape,rows,n_log2,depth,with_cvs", [
    ("t20", 59, 20, 10, True), ("t24", 59, 24, 10, False), ("fri27", 1, 27, 11, False),
])
def test_chunk_roots_kernel_equals_plain_at_the_prove_s_shapes(card, shape, rows, n_log2, depth,
                                                               with_cvs):
    """K13 == chunk_roots_plain (the eager composition on K1) on the same
    tensors: the 59 columns of T = 2^20 with their leaf CVs, of T = 2^24
    roots only, a FRI layer of 2^27 with the empty prefix; one launch, and
    the (column, chunk) trees added to `blake3.chunk_trees`."""
    n = 1 << n_log2
    vals = _bits(rows, n, 1900 + n_log2, card)
    prefixes = LABELS if rows == 59 else [b""]
    cvs = torch.empty((rows, 8, n), dtype=torch.int32, device=card) if with_cvs else None
    before = BT.chunk_roots.launches
    rec = tracing.Recorder()
    with tracing.proving({}, rec):
        got = BT.chunk_roots(vals, prefixes, depth, cvs=cvs)
    assert BT.chunk_roots.launches == before + 1
    assert tracing.counters(rec.spans()) == {"blake3.chunk_trees": rows * (n >> depth)}
    want_cvs = torch.empty_like(cvs) if with_cvs else None
    assert torch.equal(got, BT.chunk_roots_plain(vals, prefixes, depth, cvs=want_cvs)), shape
    if with_cvs:
        assert torch.equal(cvs, want_cvs)


@pytest.mark.parametrize("depth", list(BT.CHUNK_ROOTS_LOG2))
def test_chunk_roots_kernel_equals_its_model_at_both_depths(card, depth):
    """K13 == chunk_roots_model at both chunk depths it takes, with a row
    selection (a row twice), with and without CVs, on rows 16-byte aligned
    and 8 bytes off (an odd row stride), and with the empty prefix."""
    aligned = _bits(8, 1 << 13, 2000 + depth, card)
    off = torch.empty((8, (1 << 13) + 1), dtype=torch.int64, device=card)[:, 1:]
    off.copy_(aligned)
    pick = [LABELS[i] for i in (0, 3, 17, 58, 5)]
    idx = [7, 0, 3, 3, 6]
    want_cvs = torch.empty((5, 8, 1 << 13), dtype=torch.int32, device=card)
    want = BT.chunk_roots_model(aligned, pick, depth, idx, cvs=want_cvs)
    for vals in (aligned, off):
        cvs = torch.empty_like(want_cvs)
        assert torch.equal(BT.chunk_roots(vals, pick, depth, idx, cvs=cvs), want)
        assert torch.equal(cvs, want_cvs)
        assert torch.equal(BT.chunk_roots(vals, pick, depth, idx), want)
    assert torch.equal(BT.chunk_roots(aligned[:1], [b""], depth),
                       BT.chunk_roots_model(aligned[:1], [b""], depth))


def test_chunk_roots_refuses_what_the_kernel_does_not_take(card):
    vals = _bits(2, 1 << 12, 2100, card)
    pre = LABELS[:2]
    for depth in (9, 12):
        with pytest.raises(ValueError):
            BT.chunk_roots(vals, pre, depth)
    with pytest.raises(ValueError):
        BT.chunk_roots(vals.to(torch.int32), pre, 10)
    with pytest.raises(ValueError):
        BT.chunk_roots(vals.t().contiguous().t(), pre, 10)  # columns not unit-strided
    with pytest.raises(ValueError):
        BT.chunk_roots(vals[:, : 3 << 9], pre, 10)  # 1536 rows: a ragged chunk
    for cvs in (torch.empty((2, 8, 1 << 11), dtype=torch.int32, device=card),
                torch.empty((2, 8, 1 << 12), dtype=torch.int64, device=card)):
        with pytest.raises(ValueError):
            BT.chunk_roots(vals, pre, 10, cvs=cvs)
