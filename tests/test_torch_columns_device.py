"""Port columns_device (on the CPU) vs the JAX package's columns_device and
the host numpy columns/composition: derived columns, range derivation, the
AIR composition (one pass and slab by slab), the packed and unpacked log
uploads, and the column engine over device columns with zero memory budgets.

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
    # the state carried across: raw inputs and derived planes
    carried = convert.device_columns_from_reference(case["ref_dc"])
    assert np.array_equal(carried.to_host(), got)
    planes = convert.field_from_planes(np.asarray(case["ref_dc"].lo), np.asarray(case["ref_dc"].hi))
    assert torch.equal(planes, case["dc"].planes)


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


def _raw_unpacked(h):
    return (
        np.ascontiguousarray(h["tape_mv"].T),
        np.ascontiguousarray(h["wflag"].astype(np.uint8).T),
        np.ascontiguousarray(h["wsym"].astype(np.int32).T),
    )


def test_packed_and_unpacked_log_uploads_agree():
    blocks = partition_trace(generate_trace(1 << 11, 2), 256)
    dc = CD.DeviceColumns(blocks, "cpu")
    assert dc._packed
    h = CD._host_inputs(blocks)
    pk = CD.pack_logs(h["tape_mv"].T, h["wflag"].T, h["wsym"].T)
    assert np.array_equal(pk, RCD.pack_logs(h["tape_mv"].T, h["wflag"].T, h["wsym"].T))
    tmv, wfl, wsy = CD._unpack_logs(torch.from_numpy(np.ascontiguousarray(pk)))
    assert np.array_equal(tmv.numpy(), h["tape_mv"].T)
    assert np.array_equal(wfl.numpy(), h["wflag"].T.astype(np.uint8))
    assert np.array_equal(wsy.numpy(), h["wsym"].T.astype(np.int32))

    anchor, carry = CD._cumsum_anchors(torch.from_numpy(h["tape_mv"].copy()), h["n"], h["tau"],
                                       h["block_start"])
    unpacked = CD.DeviceColumns.from_raw(
        h["n"], h["tau"], False, h["input_mv"], _raw_unpacked(h), h["block_of"],
        h["is_first"], h["is_last"], CD._block_table(h["win_len"]),
        CD._block_table(h["in_off"]), CD._block_table(h["out_off"]), anchor, carry, "cpu",
    )
    assert torch.equal(unpacked.planes, dc.planes)
    assert torch.equal(unpacked.derive_ranges([1024], 1024), dc.derive_ranges([1024], 1024))

    # an alphabet above 15 symbols does not fit the packed layout
    for b in blocks:
        b.movement_log.write_sym = b.movement_log.write_sym.copy()
    blocks[1].movement_log.write_sym[3, 1] = 40000
    wide = CD.DeviceColumns(blocks, "cpu")
    assert not wide._packed
    tc = TraceColumns.build(blocks)
    host = np.stack([tc.column_by_label(lb) for lb in all_labels(2)])
    assert np.array_equal(wide.to_host(), host)
    assert np.array_equal(wide.to_host(), RCD.DeviceColumns(blocks).to_host())


def test_anchors_by_segment_sums_equal_the_full_cumsum():
    blocks = partition_trace(generate_trace(1 << 12, 2), 256)
    h = CD._host_inputs(blocks)
    tmv = torch.from_numpy(h["tape_mv"].copy())
    anchor, carry = CD._cumsum_anchors(tmv, h["n"], h["tau"], h["block_start"])
    csum = np.cumsum(h["tape_mv"].astype(np.int64), axis=0)
    excl = np.vstack([np.zeros((1, h["tau"]), np.int64), csum])
    assert anchor.dtype == carry.dtype == torch.int32
    assert np.array_equal(anchor.numpy(), excl[h["block_start"]].T)
    assert np.array_equal(carry.numpy(), excl[np.arange(0, h["n"], 1024)].T)
    # block starts off the segment grid take the full-cumsum form
    ragged = np.array([0, 100, 1000, 3000], dtype=np.int32)
    a2, c2 = CD._cumsum_anchors(tmv, h["n"], h["tau"], ragged)
    assert np.array_equal(a2.numpy(), excl[ragged].T)
    assert np.array_equal(c2.numpy(), carry.numpy())


def test_device_staged_inputs_equal_the_host_ones():
    """The raw inputs DeviceColumns stages and derives on its device are the
    host arrays of _host_inputs: the packed plane, the block rows and the
    cumsum anchors."""
    blocks = partition_trace(generate_trace(1 << 12, 8), 512)
    h = CD._host_inputs(blocks)
    dc = CD.DeviceColumns(blocks, "cpu")
    assert dc._packed
    (pk,) = dc._logs
    assert np.array_equal(pk.numpy(), CD.pack_logs(h["tape_mv"].T, h["wflag"].T, h["wsym"].T))
    assert np.array_equal(dc._input_mv.numpy(), h["input_mv"])
    assert dc._block_of.dtype == torch.int32
    assert np.array_equal(dc._block_of.numpy(), h["block_of"])
    assert np.array_equal(dc._is_first.numpy(), h["is_first"])
    assert np.array_equal(dc._is_last.numpy(), h["is_last"])
    for got, want in zip(dc._tables[:3], ("win_len", "in_off", "out_off")):
        assert np.array_equal(got.numpy(), CD._block_table(h[want]))


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
