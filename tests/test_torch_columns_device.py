"""Port columns_device (on the CPU) vs the JAX package's columns_device and
the host numpy columns/composition: derived columns, range derivation, the
AIR composition (one pass and slab by slab), the packed and unpacked log
uploads, a rank's shard of the raw inputs, and the column engine over device
columns with zero memory budgets.

Tolerance: none -- field elements, digests and paths, exact equality."""

import numpy as np
import pytest
import torch

from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.ops import goldilocks_jax as FJ
from sezkp_tpu.stark.v1 import columns_device as RCD
from sezkp_tpu.stark.v1.air import Alphas as RefAlphas
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt as ntt_host
from sezkp_tpu_torch.stark.v1 import columns_device as CD
from sezkp_tpu_torch.stark.v1.air import Alphas, compose_all_rows
from sezkp_tpu_torch.stark.v1.columns import TraceColumns, all_labels
from sezkp_tpu_torch.stark.v1.masking import eval_masks_sum_at_points
from sezkp_tpu_torch.stark.v1.openings import ColumnEngine
from sezkp_tpu_torch.trace.generator import generate_trace
from sezkp_tpu_torch.trace.partition import partition_trace

P = int(G.P)
ALPHAS = [3 + 1000003 * i for i in range(8)]
MASKS = [[5, P - 11, 17, 1 << 40]]


@pytest.fixture(
    scope="module",
    params=[(1 << 11, 256, 2), (1 << 12, 512, 8), (1 << 13, 256, 8), (1 << 13, 512, 2)],
    ids=["T11_b256_tau2", "T12_b512_tau8", "T13_b256_tau8", "T13_b512_tau2"],
)
def case(request):
    t, b, tau = request.param
    blocks = partition_trace(generate_trace(t, tau), b)
    tc = TraceColumns.build(blocks)
    host = np.stack([tc.column_by_label(lb) for lb in all_labels(tau)])
    # the JAX package takes the port's blocks as they are (same attributes)
    ref_dc = RCD.DeviceColumns(blocks)
    return dict(blocks=blocks, tc=tc, host=host, ref_dc=ref_dc,
                dc=CD.DeviceColumns(blocks, "cpu"), n=t, tau=tau)


def test_columns_equal_jax_and_host(case):
    got = case["dc"].to_host()
    assert got.shape == (3 + 7 * case["tau"], case["n"])
    assert np.array_equal(got, case["host"])
    assert np.array_equal(got, case["ref_dc"].to_host())
    # the state both packages hold: raw inputs and derived planes
    _same_raw_inputs(case["dc"], case["ref_dc"])
    planes = convert.field_from_planes(np.asarray(case["ref_dc"].lo), np.asarray(case["ref_dc"].hi))
    assert torch.equal(planes, case["dc"].planes)


def _same_raw_inputs(dc, ref_dc):
    """The raw tensors DeviceColumns staged and made on its device equal the
    JAX package's raw inputs (`_args`, `_anchor`, `_carry`), value for value."""
    (input_mv, tape, wflag, wsym, block_of, _block_start, is_first, is_last,
     win_len, in_off, out_off) = (np.asarray(a) for a in ref_dc._args)
    assert dc._packed == bool(ref_dc._packed)
    # packed: the JAX package's three log slots share its one u8 plane
    want_logs = (tape,) if dc._packed else (tape, wflag, wsym)
    assert len(dc._logs) == len(want_logs)
    for got, want in zip(dc._logs, want_logs):
        assert np.array_equal(got.numpy(), want)
    assert dc._block_of.dtype == torch.int32
    for got, want in ((dc._input_mv, input_mv), (dc._block_of, block_of),
                      (dc._is_first, is_first), (dc._is_last, is_last)):
        assert np.array_equal(got.numpy(), want)
    for got, want in zip(dc._tables, (win_len, in_off, out_off, np.asarray(ref_dc._anchor))):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(dc._carry.numpy(), np.asarray(ref_dc._carry))


def test_derive_ranges_equal_slices_of_the_planes(case):
    dc, n = case["dc"], case["n"]
    starts = [n - 1024, 0, 1024, 0]
    dc.release_planes()
    got = dc.derive_ranges(starts, 1024)
    assert not dc.planes_resident  # ranges must not rematerialize the matrix
    assert tuple(got.shape) == (4, 3 + 7 * case["tau"], 1024)
    for i, s in enumerate(starts):
        assert np.array_equal(FT.unpack(got[i]), case["host"][:, s : s + 1024])
    lo, hi = case["ref_dc"].derive_ranges(starts, 1024)
    assert np.array_equal(FT.unpack(got), FJ.unpack((np.asarray(lo), np.asarray(hi))))
    wide = dc.derive_ranges([1024], 1024 if n == 2048 else 2048)
    assert np.array_equal(FT.unpack(wide[0]), case["host"][:, 1024 : 1024 + wide.shape[2]])
    with pytest.raises(ValueError):
        dc.derive_ranges([512], 1024)
    with pytest.raises(ValueError):
        dc.derive_ranges([n], 1024)


def test_compose_equals_jax_and_host_one_pass_and_slab_by_slab(case, monkeypatch):
    n, tc = case["n"], case["tc"]
    n_log2 = n.bit_length() - 1
    comp = compose_all_rows(tc, Alphas.from_list(ALPHAS))
    w = ntt_host.powers(G.primitive_root_2exp(n_log2), n)
    want = G.add(comp, eval_masks_sum_at_points(MASKS, w))

    one_pass = CD.compose_device(case["dc"], Alphas.from_list(ALPHAS), MASKS)
    assert np.array_equal(FT.unpack(one_pass), want)
    monkeypatch.setattr(CD, "COMPOSE_SEG_LOG2", n_log2 - 3)  # eight slabs, the last one wraps
    slabs = CD.compose_device(case["dc"], Alphas.from_list(ALPHAS), MASKS, scan_min_log2=0)
    assert torch.equal(slabs, one_pass)

    if case["tau"] == 2:
        # the JAX composition takes XLA:CPU many minutes to compile at tau = 8;
        # there the host composition (which the JAX package's own tests hold
        # its device composition to) stands for it
        ref = RCD.compose_device(case["ref_dc"], RefAlphas.from_list(ALPHAS), MASKS)
        assert np.array_equal(FJ.unpack(tuple(np.asarray(x) for x in ref)), want)


def _wide_alphabet(blocks):
    for b in blocks:
        b.movement_log.write_sym = b.movement_log.write_sym.copy()
    blocks[1].movement_log.write_sym[3, 1] = 40000
    return blocks


def test_packed_and_unpacked_log_uploads_agree():
    blocks = partition_trace(generate_trace(1 << 11, 2), 256)
    dc = CD.DeviceColumns(blocks, "cpu")
    assert dc._packed
    h = RCD._host_inputs(blocks)
    (pk,) = dc._logs
    assert np.array_equal(pk.numpy(), RCD.pack_logs(h["tape_mv"].T, h["wflag"].T, h["wsym"].T))
    tmv, wfl, wsy = CD._unpack_logs(pk)
    assert np.array_equal(tmv.numpy(), h["tape_mv"].T)
    assert np.array_equal(wfl.numpy(), h["wflag"].T.astype(np.uint8))
    assert np.array_equal(wsy.numpy(), h["wsym"].T.astype(np.int32))
    _same_raw_inputs(dc, RCD.DeviceColumns(blocks))
    tc = TraceColumns.build(blocks)
    host = np.stack([tc.column_by_label(lb) for lb in all_labels(2)])
    assert np.array_equal(dc.to_host(), host)

    # an alphabet above 15 symbols does not fit the packed layout
    wide = CD.DeviceColumns(_wide_alphabet(blocks), "cpu")
    assert not wide._packed
    h = RCD._host_inputs(blocks)
    for got, want in zip(wide._logs, (h["tape_mv"].T, h["wflag"].T.astype(np.uint8),
                                      h["wsym"].T.astype(np.int32))):
        assert np.array_equal(got.numpy(), want)
    ref_wide = RCD.DeviceColumns(blocks)
    _same_raw_inputs(wide, ref_wide)
    tc = TraceColumns.build(blocks)
    host = np.stack([tc.column_by_label(lb) for lb in all_labels(2)])
    assert np.array_equal(wide.to_host(), host)
    assert np.array_equal(wide.to_host(), ref_wide.to_host())
    assert np.array_equal(FT.unpack(wide.derive_ranges([1024], 1024)[0]), host[:, 1024:2048])


def test_anchors_by_segment_sums_equal_the_full_cumsum():
    blocks = partition_trace(generate_trace(1 << 12, 2), 256)
    h = RCD._host_inputs(blocks)
    tmv = torch.from_numpy(h["tape_mv"].copy())
    grid = np.arange(0, h["n"], 1024)
    anchor, carry = CD._cumsum_anchors(tmv, h["block_start"], grid)
    csum = np.cumsum(h["tape_mv"].astype(np.int64), axis=0)
    excl = np.vstack([np.zeros((1, h["tau"]), np.int64), csum])
    assert anchor.dtype == carry.dtype == torch.int32
    assert np.array_equal(anchor.numpy(), excl[h["block_start"]].T)
    assert np.array_equal(carry.numpy(), excl[grid].T)
    ref = RCD.DeviceColumns(blocks)
    assert np.array_equal(anchor.numpy(), np.asarray(ref._anchor))
    assert np.array_equal(carry.numpy(), np.asarray(ref._carry))
    # block starts off the segment grid take the full-cumsum form
    ragged = np.array([0, 100, 1000, 3000], dtype=np.int32)
    a2, c2 = CD._cumsum_anchors(tmv, ragged, grid)
    assert np.array_equal(a2.numpy(), excl[ragged].T)
    assert np.array_equal(c2.numpy(), carry.numpy())
    # and so do rows off the granule grid (a shard's first row)
    rows = np.array([0, 512, 1536, 3000])
    a3, c3 = CD._cumsum_anchors(tmv, h["block_start"], rows)
    assert np.array_equal(a3.numpy(), anchor.numpy())
    assert np.array_equal(c3.numpy(), excl[rows].T)


def test_device_staged_inputs_equal_the_host_ones():
    """The raw inputs DeviceColumns stages and derives on its device are the
    JAX package's host arrays (_host_inputs, pack_logs): the packed plane,
    the block rows and tables, and the cumsum anchors."""
    blocks = partition_trace(generate_trace(1 << 12, 8), 512)
    h = RCD._host_inputs(blocks)
    dc = CD.DeviceColumns(blocks, "cpu")
    assert dc._packed
    (pk,) = dc._logs
    assert np.array_equal(pk.numpy(), RCD.pack_logs(h["tape_mv"].T, h["wflag"].T, h["wsym"].T))
    assert np.array_equal(dc._input_mv.numpy(), h["input_mv"])
    assert dc._block_of.dtype == torch.int32
    assert np.array_equal(dc._block_of.numpy(), h["block_of"])
    assert np.array_equal(dc._is_first.numpy(), h["is_first"])
    assert np.array_equal(dc._is_last.numpy(), h["is_last"])
    for got, want in zip(dc._tables[:3], ("win_len", "in_off", "out_off")):
        assert np.array_equal(got.numpy(), h[want].T & 0xFFFFFFFF)
    excl = np.vstack([np.zeros((1, 8), np.int64), np.cumsum(h["tape_mv"].astype(np.int64), axis=0)])
    assert np.array_equal(dc._tables[3].numpy(), excl[h["block_start"]].T)
    assert np.array_equal(dc._carry.numpy(), excl[::1024][: h["n"] >> 10].T)


@pytest.mark.parametrize("t,b,tau,d,wide", [
    (1 << 12, 256, 2, 2, False),
    (1 << 12, 1000, 2, 4, False),  # shards start inside blocks
    (1 << 12, 512, 8, 8, False),  # n/D = 512, below the 2^10 granule
    (1 << 12, 256, 2, 2, True),  # unpacked logs
], ids=["T12_b256_tau2_D2", "T12_b1000_tau2_D4", "T12_b512_tau8_D8", "T12_b256_tau2_D2_wide"])
def test_shard_planes_are_slices_of_the_whole(t, b, tau, d, wide):
    """Every rank's DeviceColumns(rows=...) derives the whole trace's columns
    of its rows: the packing decided and the anchors summed over the whole
    trace, the carry at its first row."""
    blocks = partition_trace(generate_trace(t, tau), b)
    if wide:
        _wide_alphabet(blocks)
    whole = CD.DeviceColumns(blocks, "cpu")
    assert whole._packed != wide
    tape = np.concatenate([bl.movement_log.tape_mv for bl in blocks]).astype(np.int64)
    for r in range(d):
        lo, hi = r * t // d, (r + 1) * t // d
        shard = CD.DeviceColumns(blocks, "cpu", rows=(lo, hi))
        assert shard._packed == whole._packed
        assert tuple(shard._input_mv.shape) == (hi - lo,)
        assert all(a.shape[-1] == hi - lo for a in shard._logs)
        assert np.array_equal(shard._carry.numpy()[:, 0], tape[:lo].sum(axis=0))
        assert torch.equal(shard._tables[3], whole._tables[3])
        # what the rank keeps is its own, no view of a whole-trace buffer
        # (the input moves are left out: on the CPU their upload is a view
        # of the staged rows by design, on the card a copy of its rows)
        for a in (shard._carry, shard._block_of, shard._is_first, shard._is_last, *shard._logs,
                  *shard._tables):
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
        assert torch.equal(shard.planes, whole.planes[:, lo:hi])
        shard.release_planes()
        assert not shard.planes_resident
        assert torch.equal(shard.planes, whole.planes[:, lo:hi])


def test_derive_ranges_refuses_a_shard():
    blocks = partition_trace(generate_trace(1 << 12, 2), 256)
    shard = CD.DeviceColumns(blocks, "cpu", rows=(2048, 4096))
    with pytest.raises(ValueError):
        shard.derive_ranges([0], 1024)
    for rows in ((2048, 2048), (-1, 1024), (0, 4097)):  # no rows, or rows off the trace
        with pytest.raises(ValueError):
            CD.DeviceColumns(blocks, "cpu", rows=rows)


@pytest.mark.parametrize("t,b,tau", [(1 << 12, 1000, 2), (1 << 12, 300, 8), (3000, 256, 3)],
                         ids=["T12_b1000_tau2", "T12_b300_tau8", "T3000_b256_tau3"])
def test_ragged_blocks_derive_the_host_columns(t, b, tau):
    """Blocks off the power-of-two grid (and a trace off it) take the full
    cumsum on the device; the columns still equal the host's."""
    blocks = partition_trace(generate_trace(t, tau), b)
    tc = TraceColumns.build(blocks)
    host = np.stack([tc.column_by_label(lb) for lb in all_labels(tau)])
    dc = CD.DeviceColumns(blocks, "cpu")
    assert np.array_equal(dc.to_host(), host)
    starts = [0, 1024] if t >= 2048 else [0]
    got = dc.derive_ranges(starts, 1024)
    for k, s in enumerate(starts):
        assert torch.equal(got[k], dc.planes[:, s : s + 1024])


def test_from_i64_small_edges():
    x = np.array([-1, 0, 1, 2**31 - 1, -(2**31 - 1), -2, 65536, -65536], dtype=np.int64)
    for dtype in (torch.int32, torch.int64):
        got = FT.unpack(CD._from_i64_small(torch.from_numpy(x).to(dtype)))
        assert np.array_equal(got, G.from_i64(x))
    assert int(FT.unpack(CD._from_i64_small(torch.tensor([-1], dtype=torch.int8)))[0]) == P - 1
    lo, hi = RCD._from_i64_small(np.asarray(x, dtype=np.int32))
    assert np.array_equal(FJ.unpack((np.asarray(lo), np.asarray(hi))), G.from_i64(x))


def _same_openings(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.value_le == w.value_le
        assert (g.index, g.chunk_index, g.index_in_chunk) == (w.index, w.chunk_index, w.index_in_chunk)
        assert g.chunk_root == w.chunk_root
        assert g.path_in_chunk == w.path_in_chunk
        assert g.path_to_chunk == w.path_to_chunk


def test_engine_over_device_columns_every_memory_policy(case):
    """Resident CVs, roots-scan + recompute from the matrix, roots-scan +
    range-derived openings: all equal the host engine."""
    n, tau = case["n"], case["tau"]
    host = ColumnEngine(case["tc"], device="cpu", device_hash_min=1 << 62)
    want_roots = [(r.label, r.root) for r in host.build_roots()]
    reqs = [("mv_0", 5), (f"head_{tau - 1}", n // 2), ("input_mv", n - 1), ("is_first", 0),
            (f"wflag_{tau - 1}", 1027), ("is_last", n - 1), (f"out_off_0", 1024), ("mv_0", 6)]
    want = host.open_batch(reqs)

    dc = CD.DeviceColumns(case["blocks"], "cpu")
    resident = ColumnEngine(None, dc=dc)
    assert [(r.label, r.root) for r in resident.build_roots()] == want_roots
    assert resident._dev_cvs is not None
    _same_openings(resident.open_batch(reqs), want)

    lean = ColumnEngine(None, dc=dc, cv_budget_bytes=0)
    assert [(r.label, r.root) for r in lean.build_roots()] == want_roots
    assert lean._dev_cvs is None  # roots only
    assert dc.planes_resident
    _same_openings(lean.open_batch(reqs), want)  # recomputed from the matrix
    dc.release_planes()
    _same_openings(lean.open_batch(reqs), want)  # recomputed from derived ranges
    assert not dc.planes_resident
    _same_openings([lean.open("head_0", 77)], [host.open("head_0", 77)])
