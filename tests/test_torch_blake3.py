"""Port BLAKE3 (plain versions, on the CPU) vs the JAX package: the Pallas
kernels in interpret mode, the staged XLA form, and the host hasher.

Tolerance: none -- digests and roots are compared byte for byte.

The chain kernel of the JAX package is run in interpret mode only up to two
blocks (L <= 128): XLA:CPU does not finish compiling its unrolled body at
three blocks within minutes. Longer messages are held against the staged form
and the host hasher."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sezkp_tpu.ops import blake3_jax as BJ
from sezkp_tpu.ops import blake3_pallas as BP
from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.stark.v1 import merkle as M
from sezkp_tpu.stark.v1 import params
from sezkp_tpu.stark.v1.columns import all_labels
from sezkp_tpu.crypto import blake3 as host_blake3
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.crypto import blake3 as port_blake3
from sezkp_tpu_torch.ops import blake3_torch as BT
from sezkp_tpu_torch.ops import goldilocks_torch as FT

P = int(G.P)
FLAGS = int(BJ.CHUNK_START | BJ.CHUNK_END | BJ.ROOT)

# (block_len, flags, out_words): 8 = FRI leaf, 24-29 = labeled column leaf,
# 64 = Merkle parent
CASES = [(8, 11, 8), (24, 11, 8), (27, 11, 8), (29, 11, 8), (64, 11, 8), (64, 11, 16)]


def _prefix(lb: str) -> bytes:
    return params.DS_COL_LEAF.encode() + struct.pack("<I", len(lb)) + lb.encode()


@pytest.mark.parametrize("n", [1, 127, 1024])
@pytest.mark.parametrize("block_len,flags,out_words", CASES)
def test_compress_matches_pallas_and_staged(n, block_len, flags, out_words):
    assert flags == FLAGS
    rng = np.random.default_rng(1000 * n + block_len + out_words)
    m16 = rng.integers(0, 2**32, (16, n), dtype=np.uint32)
    got = convert.planes_from_cvs(
        BT.compress(convert.cvs_from_planes(m16), block_len, flags, out_words)
    )
    staged = np.asarray(BJ.compress_planes_staged(jnp.asarray(m16), block_len, flags, out_words))
    assert np.array_equal(got, staged)
    if n in (1, 1024):  # the Pallas kernel itself, interpret mode (slow per compile)
        pallas = np.asarray(
            BP.compress_rows(jnp.asarray(m16.T), block_len, flags, out_words, interpret=True)
        ).T
        assert np.array_equal(got, pallas)


def test_compress_is_plain_on_cpu_and_counts_no_launch():
    before = BT.compress.launches
    m16 = torch.zeros((16, 4), dtype=torch.int32)
    out = BT.compress(m16, 64, FLAGS, 8)
    assert torch.equal(out, BT.compress_plain(m16, 64, FLAGS, 8))
    assert BT.compress.launches == before


def test_labeled_leaves_every_prefix_length():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, P, 300, dtype=np.uint64)
    vals[:3] = [0, P - 1, 2**32]
    seen = set()
    for lb in all_labels(8):
        pre = _prefix(lb)
        if len(pre) in seen:
            continue
        seen.add(len(pre))
        got = BT.cv_planes_to_bytes(BT.hash_leaves_u64_planes(FT.pack(vals), pre))
        want = M.hash_field_leaves_labeled(G.to_le_bytes(vals), lb)
        assert np.array_equal(got, want), lb
    assert seen == {16, 18, 19, 20, 21}
    # empty prefix = FRI leaf
    got = BT.cv_planes_to_bytes(BT.hash_leaves_u64_planes(FT.pack(vals), b""))
    assert np.array_equal(got, M.hash_field_leaves(G.to_le_bytes(vals)))


def test_parent_level_matches_jax():
    rng = np.random.default_rng(6)
    cv = rng.integers(0, 2**32, (8, 64), dtype=np.uint32)
    want = np.asarray(BJ.parent_level_planes(jnp.asarray(cv)))
    got = convert.planes_from_cvs(BT.parent_level_planes(convert.cvs_from_planes(cv)))
    assert np.array_equal(got, want)


def _resident_paths(cvs, cols, starts, idxs, chunk_log2):
    """chunk_path_planes as ColumnEngine.open_batch runs it over resident
    leaf CVs: (paths uint8 [K, chunk_log2, 32], chunk roots uint8 [K, 32])."""
    planes, roots = BT.chunk_path_planes(cvs, *(BT._as_index(a, cvs.device) for a in (cols, starts, idxs)),
                                         chunk_log2)
    return BT.path_planes_to_bytes(planes, len(starts), chunk_log2), BT.cv_planes_to_bytes(roots)


def _rebuilt_paths(table, src, prefixes, idxs, chunk_log2):
    """chunk_tree_planes as ColumnEngine.open_batch runs it without resident
    leaf CVs: request k opens leaf idxs[k] of the chunk in row src[k] of
    `table` (int64 [rows, chunk]), hashed with prefixes[k]; a tree a
    request. Returns (paths uint8 [K, chunk_log2, 32], roots uint8 [K, 32],
    the opened values uint64 [K])."""
    k, dev = len(src), table.device
    order, bounds = BT.prefix_groups(prefixes)
    planes, roots, opened = BT.chunk_tree_planes(
        table[BT._as_index(src, dev)], BT._as_index(order, dev), bounds,
        torch.arange(k, device=dev), BT._as_index(idxs, dev), chunk_log2)
    return (BT.path_planes_to_bytes(planes, k, chunk_log2), BT.cv_planes_to_bytes(roots),
            FT.unpack(opened))


def test_columns_commit_and_chunk_paths_match_jax():
    rng = np.random.default_rng(7)
    chunk_log2 = 5
    lbs = ["mv_0", "mv_1", "mv_2"]  # one prefix length, as the JAX function requires
    prefixes = [_prefix(lb) for lb in lbs]
    vals = rng.integers(0, P, (3, 256), dtype=np.uint64)

    cvs_j, croots_j = BJ.columns_commit_device(vals, prefixes, chunk_log2, resident=True)
    cvs_t, roots_t = BT.columns_commit_from_planes(FT.pack(vals), prefixes, chunk_log2)
    assert np.array_equal(BT.croots_to_host(roots_t), croots_j)
    # leaf CVs: JAX keeps [C, n, 8] rows, the port [C, 8, n] planes
    assert np.array_equal(
        convert.planes_from_cvs(cvs_t).transpose(0, 2, 1), np.asarray(cvs_j)
    )

    cols = np.array([0, 2, 1, 2])
    rows = np.array([3, 77, 255, 128])
    starts = (rows >> chunk_log2) << chunk_log2
    idxs = rows - starts
    n = vals.shape[1]
    paths_j, roots_j = BJ.chunk_paths_device(
        jnp.asarray(cvs_j).reshape(-1, 8), cols * n + starts, idxs, chunk_log2
    )
    paths_t, r_t = _resident_paths(cvs_t, cols, starts, idxs, chunk_log2)
    assert np.array_equal(paths_t, paths_j)
    assert np.array_equal(r_t, roots_j)
    for k in range(len(rows)):
        assert np.array_equal(r_t[k], croots_j[cols[k], rows[k] >> chunk_log2])


def test_commit_from_planes_selection_and_roots_scan_match_resident_and_jax():
    rng = np.random.default_rng(8)
    chunk_log2 = 4
    n = 256
    vals = rng.integers(0, P, (5, n), dtype=np.uint64)
    planes = FT.pack(vals)
    # any prefix lengths in one call, rows picked by idx
    lbs = ["head_1", "is_first", "mv_0", "input_mv"]
    idx = [3, 0, 4, 1]
    prefixes = [_prefix(lb) for lb in lbs]
    cvs, roots = BT.columns_commit_from_planes(planes, prefixes, chunk_log2, idx=idx)
    assert tuple(cvs.shape) == (4, 8, n) and tuple(roots.shape) == (4, 8, n >> chunk_log2)
    croots = BT.croots_to_host(roots)
    for i, (lb, row) in enumerate(zip(lbs, idx)):
        leaves = M.hash_field_leaves_labeled(G.to_le_bytes(vals[row]), lb)
        assert np.array_equal(BT.cv_planes_to_bytes(cvs[i]), leaves)
        want = M.ColumnCommit.from_hashed_leaves(leaves, chunk_log2)
        assert [bytes(r) for r in croots[i]] == [bytes(r) for r in want.chunk_roots]

    for seg_log2 in (4, 6, 16):  # one chunk per segment, four, the whole column
        scan = BT.columns_commit_roots_scan(planes, prefixes, chunk_log2, idx=idx, seg_log2=seg_log2)
        assert torch.equal(scan, roots)

    # the JAX functions, one prefix length per call as they require
    same_len = [_prefix(lb) for lb in ("mv_0", "mv_1", "mv_2")]
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    jidx = np.array([4, 2, 0], np.int32)
    _cvs_j, croots_j = BJ.columns_commit_from_planes(lo, hi, same_len, chunk_log2, idx=jidx)
    scan_j = BJ.croots_to_host(np.asarray(
        BJ.columns_commit_roots_scan(lo, hi, same_len, chunk_log2, idx=jidx, seg_log2=6)))
    _, roots_t = BT.columns_commit_from_planes(planes, same_len, chunk_log2, idx=jidx)
    scan_t = BT.columns_commit_roots_scan(planes, same_len, chunk_log2, idx=jidx, seg_log2=6)
    assert np.array_equal(BT.croots_to_host(roots_t), croots_j)
    assert np.array_equal(BT.croots_to_host(scan_t), scan_j)


def test_chunk_paths_from_planes_and_ranges_match_resident_and_jax():
    rng = np.random.default_rng(9)
    chunk_log2 = 5
    chunk = 1 << chunk_log2
    n = 256
    lbs = ["mv_0", "mv_1", "mv_2"]
    prefixes = [_prefix(lb) for lb in lbs]
    vals = rng.integers(0, P, (3, n), dtype=np.uint64)
    planes = FT.pack(vals)
    cvs, _ = BT.columns_commit_from_planes(planes, prefixes, chunk_log2)

    cols = np.array([0, 2, 1, 2, 0])
    rows = np.array([3, 77, 255, 128, 64])
    starts = (rows >> chunk_log2) << chunk_log2
    idxs = rows - starts
    req_prefixes = [prefixes[c] for c in cols]
    want_paths, want_roots = _resident_paths(cvs, cols, starts, idxs, chunk_log2)

    # the resident matrix: a chunk is a row of its [C * n / chunk, chunk] view
    by_chunk = planes.reshape(-1, chunk)
    src = (cols * n + starts) // chunk
    paths, roots, opened = _rebuilt_paths(by_chunk, src, req_prefixes, idxs, chunk_log2)
    assert np.array_equal(paths, want_paths) and np.array_equal(roots, want_roots)
    assert np.array_equal(opened, vals[cols, rows])

    # ranges [S, C, chunk]: the distinct chunks of the requests, a chunk a
    # row of their [S * C, chunk] view
    uniq, sel = np.unique(starts, return_inverse=True)
    ranges = torch.stack([planes[:, s : s + chunk] for s in uniq])
    paths_r, roots_r, opened_r = _rebuilt_paths(
        ranges.reshape(-1, chunk), sel * len(lbs) + cols, req_prefixes, idxs, chunk_log2)
    assert np.array_equal(paths_r, want_paths) and np.array_equal(roots_r, want_roots)
    assert np.array_equal(opened_r, opened)

    # requests under labels of different prefix lengths in one call
    mixed = [_prefix(lb) for lb in ("input_mv", "head_7", "mv_0", "is_last", "head_7")]
    paths_m, roots_m, _ = _rebuilt_paths(by_chunk, src, mixed, idxs, chunk_log2)
    for k, lb in enumerate(("input_mv", "head_7", "mv_0", "is_last", "head_7")):
        leaves = M.hash_field_leaves_labeled(
            G.to_le_bytes(vals[cols[k], starts[k] : starts[k] + chunk]), lb)
        tree = M.MerkleTree.from_leaves(leaves)
        assert bytes(roots_m[k]) == tree.root()
        assert [bytes(p) for p in paths_m[k]] == tree.open(int(idxs[k]))

    # the JAX functions
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    out, finish = BJ.chunk_paths_from_planes(lo, hi, cols, starts, idxs, req_prefixes, chunk_log2)
    paths_j, roots_j, vlo, vhi = finish(*(np.asarray(o) for o in out))
    assert np.array_equal(paths, paths_j) and np.array_equal(roots, roots_j)
    assert np.array_equal(opened, vlo.astype(np.uint64) | (vhi.astype(np.uint64) << np.uint64(32)))
    rlo = jnp.stack([lo[:, s : s + chunk] for s in uniq])
    rhi = jnp.stack([hi[:, s : s + chunk] for s in uniq])
    out, finish = BJ.chunk_paths_from_ranges(rlo, rhi, sel, cols, idxs, req_prefixes, chunk_log2)
    paths_j, roots_j, _, _ = finish(*(np.asarray(o) for o in out))
    assert np.array_equal(paths_r, paths_j) and np.array_equal(roots_r, roots_j)

    empty = _rebuilt_paths(by_chunk, [], [], [], chunk_log2)
    assert empty[0].shape == (0, chunk_log2, 32) and empty[1].shape == (0, 32)
    assert empty[2].shape == (0,)
    assert _resident_paths(cvs, [], [], [], chunk_log2)[0].shape == (0, chunk_log2, 32)


# ---------------- single-chunk messages of any length (K7's plain version) ---


def _messages(n, length):
    return np.random.default_rng(7000 * n + length).integers(0, 256, (n, length), dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 29])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 128])
def test_chain_plain_matches_pallas_interpret(n, length):
    msgs = _messages(n, length)
    planes = BT.messages_to_planes(msgs, "cpu")
    assert planes.shape == (16 * -(-length // 64), n) and planes.dtype == torch.int32
    got = BT.hash_many_words_plain(planes, length)
    pallas = np.asarray(
        BP.hash_many_words(jnp.asarray(convert.planes_from_cvs(planes)), length, interpret=True)
    )
    assert np.array_equal(convert.planes_from_cvs(got), pallas)
    assert np.array_equal(BT.cv_planes_to_bytes(got), host_blake3.hash_many(msgs))


@pytest.mark.parametrize("n", [1, 29])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 129, 320, 813, 1024])
def test_chain_matches_staged_and_host(n, length):
    msgs = _messages(n, length)
    planes = BT.messages_to_planes(msgs, "cpu")
    got = BT.cv_planes_to_bytes(BT.hash_many_words_plain(planes, length))
    assert np.array_equal(got, BJ.hash_many_device(msgs))
    assert np.array_equal(got, host_blake3.hash_many(msgs))
    assert np.array_equal(got, port_blake3.hash_many(msgs))
    # the host-bytes entry, and the wrapper on a CPU tensor with a destination
    assert np.array_equal(BT.hash_many_device(msgs, device="cpu"), got)
    out = torch.empty((8, n), dtype=torch.int32)
    assert BT.hash_many_words(planes, length, out=out) is out
    assert np.array_equal(BT.cv_planes_to_bytes(out), got)


def test_chain_planes_are_the_reference_layout():
    """messages_to_planes == the numpy pad / view / transpose of the JAX entry."""
    msgs = _messages(5, 130)
    padded = np.zeros((5, 192), dtype=np.uint8)
    padded[:, :130] = msgs
    want = np.ascontiguousarray(padded.view("<u4").T)
    assert np.array_equal(convert.planes_from_cvs(BT.messages_to_planes(msgs, "cpu")), want)


def test_chain_is_plain_on_cpu_and_counts_no_launch():
    before = BT.hash_many_words.launches
    planes = BT.messages_to_planes(_messages(3, 200), "cpu")
    assert torch.equal(BT.hash_many_words(planes, 200), BT.hash_many_words_plain(planes, 200))
    assert BT.hash_many_words.launches == before


def test_compress_plain_takes_a_chaining_value():
    """cv=None is the IV; a given cv is used as the first eight state words."""
    m16 = convert.cvs_from_planes(np.random.default_rng(3).integers(0, 2**32, (16, 9), dtype=np.uint32))
    iv = torch.tensor([BT._s32(w) for w in BT.IV], dtype=torch.int32)[:, None].expand(8, 9)
    assert torch.equal(BT.compress_plain(m16, 64, 1, 8, cv=iv), BT.compress_plain(m16, 64, 1, 8))
    assert not torch.equal(BT.compress_plain(m16, 64, 1, 8, cv=iv + 1), BT.compress_plain(m16, 64, 1, 8))


@pytest.mark.parametrize(
    "shape,length",
    [((16, 4), 0), ((272, 4), 1025), ((16, 4), 65), ((32, 4), 64), ((4, 16), 64)],
)
def test_chain_wrapper_refuses(shape, length):
    with pytest.raises(ValueError):
        BT.hash_many_words(torch.zeros(shape, dtype=torch.int32), length)


def test_chain_wrapper_refuses_wrong_dtype():
    with pytest.raises(ValueError):
        BT.hash_many_words(torch.zeros((16, 4), dtype=torch.int64), 64)


def test_hash_many_device_default_device_is_the_card():
    msgs = _messages(4, 100)
    if torch.cuda.is_available():
        assert np.array_equal(BT.hash_many_device(msgs), host_blake3.hash_many(msgs))
    else:
        with pytest.raises(RuntimeError):
            BT.hash_many_device(msgs)
