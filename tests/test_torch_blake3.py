"""Port BLAKE3 (plain versions, on the CPU) vs the JAX package: the Pallas
kernel in interpret mode, the staged XLA form, and the host hasher.

Tolerance: none -- digests and roots are compared byte for byte."""

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
from sezkp_tpu_torch import convert
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


def test_columns_commit_and_chunk_paths_match_jax():
    rng = np.random.default_rng(7)
    chunk_log2 = 5
    lbs = ["mv_0", "mv_1", "mv_2"]  # one prefix length, as the JAX function requires
    prefixes = [_prefix(lb) for lb in lbs]
    vals = rng.integers(0, P, (3, 256), dtype=np.uint64)

    cvs_j, croots_j = BJ.columns_commit_device(vals, prefixes, chunk_log2, resident=True)
    cvs_t, roots_t = BT.columns_commit_device(FT.pack(vals), prefixes, chunk_log2)
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
    paths_t, r_t = BT.chunk_paths_device(cvs_t, cols, starts, idxs, chunk_log2)
    assert np.array_equal(paths_t, paths_j)
    assert np.array_equal(r_t, roots_j)
    for k in range(len(rows)):
        assert np.array_equal(r_t[k], croots_j[cols[k], rows[k] >> chunk_log2])
