"""K13 blake3_chunk_roots on the CPU: its schedule in tensor code
(blake3_torch.chunk_roots_model) against its plain version (chunk_roots_plain,
the composition the kernel replaces), the JAX package's column commitments
and the host Merkle code. The kernel itself runs only on the card
(tests/test_torch_card.py).

Tolerance: none -- roots and CVs are compared word for word."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sezkp_tpu.ops import blake3_jax as BJ
from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.stark.v1 import merkle as M
from sezkp_tpu.stark.v1 import params
from sezkp_tpu.stark.v1.columns import all_labels
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.ops import blake3_torch as BT
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.utils import tracing

P = int(G.P)
LABELS = all_labels(8)


def _prefix(lb: str) -> bytes:
    return params.DS_COL_LEAF.encode() + struct.pack("<I", len(lb)) + lb.encode()


# every column label of tau = 8, then the FRI's empty prefix
PREFIXES = [_prefix(lb) for lb in LABELS] + [b""]


def _values(rows: int, n: int, seed: int) -> np.ndarray:
    vals = np.random.default_rng(seed).integers(0, P, (rows, n), dtype=np.uint64)
    vals[0, :4] = [0, 1, P - 1, 2**32]
    return vals


def test_the_prefixes_take_every_splice_offset_and_the_table_holds_them():
    assert len(LABELS) == 59
    assert {len(p) % 4 for p in PREFIXES} == {0, 1, 2, 3}
    rows = list(range(len(PREFIXES)))[::-1]
    table = BT._prefix_table(PREFIXES, rows).view(np.uint32)
    assert table.shape == (60, 18)
    for i, (p, r) in enumerate(zip(PREFIXES, rows)):
        words = np.frombuffer(p + bytes(64 - len(p)), dtype="<u4")
        assert np.array_equal(table[i, :16], words)
        assert (table[i, 16], table[i, 17]) == (len(p), r)
    with pytest.raises(ValueError):
        BT._prefix_table([bytes(57)], [0])


@pytest.mark.parametrize("chunk_log2,with_cvs,select", [
    (10, True, False), (10, False, True), (11, False, False), (11, True, True),
])
def test_model_equals_plain_for_every_label(chunk_log2, with_cvs, select):
    """All 59 labels of tau = 8 and the empty prefix in one call (every splice
    offset), two chunks a column; with a row selection (reversed, over a
    matrix with rows to spare) or every row; with and without the CVs."""
    n = 2 << chunk_log2
    c = len(PREFIXES)
    planes = FT.pack(_values(c + 3 if select else c, n, 100 + chunk_log2))
    idx = [c + 2 - i for i in range(c)] if select else None
    if with_cvs:
        cvs_p = torch.empty((c, 8, n), dtype=torch.int32)
        cvs_m = torch.full((c, 8, n), 7, dtype=torch.int32)
    else:
        cvs_p = cvs_m = None
    want = BT.chunk_roots_plain(planes, PREFIXES, chunk_log2, idx, cvs=cvs_p)
    got = BT.chunk_roots_model(planes, PREFIXES, chunk_log2, idx, cvs=cvs_m)
    assert tuple(got.shape) == (c, 8, 2)
    assert torch.equal(got, want)
    if with_cvs:
        assert torch.equal(cvs_m, cvs_p)


@pytest.mark.parametrize("chunk_log2", [10, 11])
def test_model_equals_plain_and_the_host_trees(chunk_log2):
    """Four labels of four prefix lengths, four chunks a column, a row
    selection: the model's roots and leaf CVs against the plain version and
    the host's ColumnCommit."""
    n = 4 << chunk_log2
    lbs = ["head_1", "is_first", "mv_0", "input_mv"]
    prefixes = [_prefix(lb) for lb in lbs]
    vals = _values(4, n, 200 + chunk_log2)
    planes = FT.pack(vals)
    idx = [2, 0, 3, 1]
    cvs = torch.empty((4, 8, n), dtype=torch.int32)
    got = BT.chunk_roots_model(planes, prefixes, chunk_log2, idx, cvs=cvs)
    assert torch.equal(got, BT.chunk_roots_plain(planes, prefixes, chunk_log2, idx))
    croots = BT.croots_to_host(got)
    for i, (lb, row) in enumerate(zip(lbs, idx)):
        leaves = M.hash_field_leaves_labeled(G.to_le_bytes(vals[row]), lb)
        assert np.array_equal(BT.cv_planes_to_bytes(cvs[i]), leaves)
        want = M.ColumnCommit.from_hashed_leaves(leaves, chunk_log2)
        assert [bytes(r) for r in croots[i]] == [bytes(r) for r in want.chunk_roots]


@pytest.mark.parametrize("entry,chunk_log2", [("from_planes", 10), ("roots_scan", 11)])
def test_model_matches_the_jax_column_commitments(entry, chunk_log2):
    """The JAX columns_commit_from_planes at the columns' depth (leaf CVs and
    roots, labels of one prefix length as it requires) and
    columns_commit_roots_scan at the FRI's (its empty prefix), each with a
    row selection."""
    n = 2 << chunk_log2
    vals = _values(4, n, 300 + chunk_log2)
    planes = FT.pack(vals)
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    if entry == "from_planes":
        same_len = [_prefix("mv_0"), _prefix("mv_1")]
        idx = np.array([3, 1], np.int32)
        cvs_j, croots_j = BJ.columns_commit_from_planes(lo, hi, same_len, chunk_log2, idx=idx)
        cvs = torch.empty((2, 8, n), dtype=torch.int32)
        roots = BT.chunk_roots_model(planes, same_len, chunk_log2, idx, cvs=cvs)
        assert np.array_equal(BT.croots_to_host(roots), croots_j)
        # JAX keeps [C, n, 8] rows, the port [C, 8, n] planes
        assert np.array_equal(convert.planes_from_cvs(cvs).transpose(0, 2, 1), np.asarray(cvs_j))
    else:
        empty = [b"", b""]
        idx = np.array([2, 0], np.int32)
        scan_j = BJ.croots_to_host(np.asarray(
            BJ.columns_commit_roots_scan(lo, hi, empty, chunk_log2, idx=idx, seg_log2=chunk_log2)))
        roots = BT.chunk_roots_model(planes, empty, chunk_log2, idx)
        assert np.array_equal(BT.croots_to_host(roots), scan_j)


@pytest.mark.parametrize("fn", [
    BT.chunk_roots_plain, BT.chunk_roots_model, BT.chunk_roots,
    BT.columns_commit_from_planes, BT.columns_commit_roots_scan,
])
def test_a_ragged_n_or_a_prefix_count_off_the_rows_is_refused(fn):
    planes = FT.pack(_values(2, 3 << 9, 400))  # 1536 rows: not a multiple of 2^10
    with pytest.raises(ValueError):
        fn(planes, PREFIXES[:2], 10)
    planes = FT.pack(_values(2, 1 << 10, 401))
    with pytest.raises(ValueError):
        fn(planes, PREFIXES[:3], 10)


def test_the_model_takes_the_kernel_s_depths_and_one_block_leaves():
    planes = FT.pack(_values(1, 1 << 12, 500))
    for depth in (5, 9, 12):
        with pytest.raises(ValueError):
            BT.chunk_roots_model(planes, [b""], depth)
    with pytest.raises(ValueError):
        BT.chunk_roots_model(planes, [bytes(57)], 10)


def test_on_the_cpu_no_launch_and_the_scan_counts_its_segments():
    """The wrapper on a CPU tensor: the plain version, no K13 launch and no
    `blake3.chunk_trees`; the roots scan counts its segments as it did."""
    planes = FT.pack(_values(3, 1 << 12, 600))
    before = BT.chunk_roots.launches
    rec = tracing.Recorder()
    with tracing.proving({}, rec):
        roots = BT.columns_commit_roots_scan(planes, PREFIXES[:3], 10, seg_log2=11,
                                             counter="commit.scan_segments")
        cvs, resident = BT.columns_commit_from_planes(planes, PREFIXES[:3], 10)
    assert BT.chunk_roots.launches == before
    assert tracing.counters(rec.spans()) == {"commit.scan_segments": 3 * 2}
    want = BT.chunk_roots_model(planes, PREFIXES[:3], 10)
    assert torch.equal(roots, want) and torch.equal(resident, want)
    assert torch.equal(BT.chunk_roots(planes, PREFIXES[:3], 10), want)
