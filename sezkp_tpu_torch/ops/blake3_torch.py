"""Batched single-block BLAKE3 on torch tensors, and Merkle work built on it.

Counterpart of sezkp_tpu/ops/blake3_pallas.py (the compression kernel) and of
the part of sezkp_tpu/ops/blake3_jax.py that the STARK v1 route runs: labeled
leaf hashing, Merkle parent levels, whole-column commitments (with resident
leaf CVs, or roots only) and in-chunk opening paths (from resident CVs, or
recomputed from column values).

Every message here is at most 64 bytes: one BLAKE3 compression with flags
CHUNK_START|CHUNK_END|ROOT and counter 0. Merkle parents are hashed that way
too (a 64-byte message), not with BLAKE3's PARENT flag.

Layouts. Message and digest words are ``torch.int32`` tensors holding u32 bit
patterns, word-major ("planes"): messages ``[16, N]``, chaining values
``[8, N]``. Field values are int64 tensors (see goldilocks_torch).

**Kernel K1 ``blake3_compress``** (csrc/blake3_compress.cu) replaces the
Pallas kernel ``blake3_pallas._build``. :func:`compress` launches it for a
CUDA tensor and runs :func:`compress_plain` only for a CPU tensor. Bound on
an H100: 64 B read + 32 B written per message against the memory rate, and
680 32-bit integer instructions per message (224 adds, the three-input ones
counting once, 232 xors, 224 funnel-shift rotates) against the integer rate;
the integer rate is the nearer one, so the kernel keeps all 32 words in registers and
does nothing else. The message assembly and the even/odd
gather for parents stay plain tensor code around the kernel.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import _kernels

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
ROOT = 8
LEAF_FLAGS = CHUNK_START | CHUNK_END | ROOT

_M32 = 0xFFFFFFFF


def _s32(v: int) -> int:
    """u32 value -> the signed int with the same 32 bits."""
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


# ------------------------------ plain version ------------------------------


def _rotr(x, n: int):
    # int32 >> is arithmetic: mask the sign fill away
    return ((x >> n) & ((1 << (32 - n)) - 1)) | (x << (32 - n))


def compress_plain(m16: torch.Tensor, block_len: int, flags: int, out_words: int = 8):
    """Plain PyTorch version of K1: int32 [16, N] -> int32 [out_words, N].
    Wrapping int32 adds, masked shifts; the 7 rounds unrolled in Python."""
    assert m16.dtype == torch.int32 and m16.dim() == 2 and m16.shape[0] == 16
    n = m16.shape[1]
    msg = [m16[i] for i in range(16)]

    def c(x):
        return torch.full((n,), _s32(x), dtype=torch.int32, device=m16.device)

    v = [c(IV[j]) for j in range(8)] + [
        c(IV[0]), c(IV[1]), c(IV[2]), c(IV[3]), c(0), c(0), c(block_len), c(flags),
    ]

    def g(a, b, cc, d, mx, my):
        v[a] = v[a] + v[b] + mx
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[cc] = v[cc] + v[d]
        v[b] = _rotr(v[b] ^ v[cc], 12)
        v[a] = v[a] + v[b] + my
        v[d] = _rotr(v[d] ^ v[a], 8)
        v[cc] = v[cc] + v[d]
        v[b] = _rotr(v[b] ^ v[cc], 7)

    for _r in range(7):
        g(0, 4, 8, 12, msg[0], msg[1])
        g(1, 5, 9, 13, msg[2], msg[3])
        g(2, 6, 10, 14, msg[4], msg[5])
        g(3, 7, 11, 15, msg[6], msg[7])
        g(0, 5, 10, 15, msg[8], msg[9])
        g(1, 6, 11, 12, msg[10], msg[11])
        g(2, 7, 8, 13, msg[12], msg[13])
        g(3, 4, 9, 14, msg[14], msg[15])
        msg = [msg[p] for p in MSG_PERM]

    out = [v[i] ^ v[i + 8] for i in range(8)]
    if out_words == 16:
        out += [v[8 + i] ^ _s32(IV[i]) for i in range(8)]
    return torch.stack(out, dim=0)


# --------------------------------- kernel ----------------------------------


def compress(m16: torch.Tensor, block_len: int, flags: int, out_words: int = 8, out=None):
    """K1 wrapper: int32 [16, N] message planes -> int32 [out_words, N].

    CUDA tensor: launches the kernel (or raises). CPU tensor: plain version.
    `out` optionally names a contiguous [out_words, N] int32 destination."""
    if out_words not in (8, 16):
        raise ValueError("out_words must be 8 or 16")
    if m16.dtype != torch.int32 or m16.dim() != 2 or m16.shape[0] != 16:
        raise ValueError("compress takes an int32 [16, N] tensor")
    n = m16.shape[1]
    if not m16.is_cuda:
        res = compress_plain(m16, block_len, flags, out_words)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if not m16.is_contiguous():
        raise ValueError("compress takes a contiguous message tensor")
    if out is None:
        out = torch.empty((out_words, n), dtype=torch.int32, device=m16.device)
    elif (
        out.dtype != torch.int32 or tuple(out.shape) != (out_words, n)
        or not out.is_contiguous() or out.device != m16.device
    ):
        raise ValueError("out must be a contiguous int32 [out_words, N] tensor on the same device")
    if n == 0:
        return out
    with torch.cuda.device(m16.device):
        rc = _kernels.lib().sezkp_blake3_compress(
            m16.data_ptr(), out.data_ptr(), n, int(block_len), int(flags), out_words,
            _kernels.stream_ptr(),
        )
    _kernels.check(rc, "blake3_compress")
    compress.launches += 1
    return out


compress.launches = 0


# ------------------------- leaves and parent levels -------------------------


def _prefix_words(prefix: bytes) -> np.ndarray:
    pw = np.zeros(16 * 4, dtype=np.uint8)
    pw[: len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    return pw.view("<u4").copy()  # [16]


def leaf_messages(vals: torch.Tensor, prefix: bytes) -> torch.Tensor:
    """int64 field values [N] -> int32 [16, N] messages (prefix || value_le8).
    The value bytes are spliced at byte offset len(prefix), which need not be
    word-aligned."""
    plen = len(prefix)
    assert plen + 8 <= 64
    n = vals.shape[0]
    pw = [int(w) for w in _prefix_words(prefix)]
    lo = vals & _M32
    hi = (vals >> 32) & _M32
    word0 = plen // 4
    sh = (plen % 4) * 8
    m = torch.empty((16, n), dtype=torch.int32, device=vals.device)
    for i in range(16):
        m[i] = _s32(pw[i])
    if sh == 0:
        m[word0] = lo.to(torch.int32)
        m[word0 + 1] = hi.to(torch.int32)
    else:
        m[word0] = ((pw[word0] | (lo << sh)) & _M32).to(torch.int32)
        m[word0 + 1] = (((lo >> (32 - sh)) | (hi << sh)) & _M32).to(torch.int32)
        m[word0 + 2] = (hi >> (32 - sh)).to(torch.int32)
    return m


def hash_leaves_u64_planes(vals: torch.Tensor, prefix: bytes = b"", out=None) -> torch.Tensor:
    """Hash N messages of (prefix || 8-byte LE value) -> int32 [8, N] CVs."""
    return compress(leaf_messages(vals, prefix), len(prefix) + 8, LEAF_FLAGS, 8, out=out)


def parent_level_planes(cv: torch.Tensor) -> torch.Tensor:
    """One Merkle level on [8, N] CV planes -> [8, N/2]: parent message words
    0-7 = left child (even columns), 8-15 = right child (odd columns)."""
    m16 = torch.cat([cv[:, 0::2], cv[:, 1::2]], dim=0).contiguous()
    return compress(m16, 64, LEAF_FLAGS, 8)


def cv_planes_to_bytes(cv) -> np.ndarray:
    """int32 [8, N] CV planes (tensor or array) -> uint8 [N, 32] digests."""
    if isinstance(cv, torch.Tensor):
        cv = cv.detach().cpu().numpy()
    rows = np.ascontiguousarray(np.asarray(cv).T).astype("<u4", copy=False)
    return rows.view(np.uint8).reshape(rows.shape[0], 32)


# ---------------- batched column commitment (resident leaf CVs) -------------


def _chunk_roots(cv: torch.Tensor, chunk_log2: int) -> torch.Tensor:
    """Leaf CVs [8, m] -> the roots [8, m >> chunk_log2] of their chunk trees."""
    for _ in range(chunk_log2):
        cv = parent_level_planes(cv)
    return cv


def _select(values: torch.Tensor, prefixes: Sequence[bytes], idx):
    rows = list(range(values.shape[0])) if idx is None else [int(i) for i in idx]
    assert len(prefixes) == len(rows)
    return rows


def columns_commit_from_planes(values: torch.Tensor, prefixes: Sequence[bytes],
                               chunk_log2: int, idx=None):
    """Hash and chunk-commit columns of a device-resident matrix in place
    (no copy of the values is made or uploaded).

    values: int64 [C_all, n] field tensor, n a multiple of 2^chunk_log2.
    idx: optional row selection (ints [C]); without it every row, in order.
    prefixes: one byte string per selected row (any lengths).
    Returns (cvs int32 [C, 8, n] leaf CV planes, resident on the device;
    roots int32 [C, 8, n_chunks] chunk-root planes, also on the device).
    Messages are assembled one column at a time, so the [C, 16, n] message
    tensor is never whole."""
    rows = _select(values, prefixes, idx)
    n = values.shape[1]
    assert n % (1 << chunk_log2) == 0
    cvs = torch.empty((len(rows), 8, n), dtype=torch.int32, device=values.device)
    roots = torch.empty((len(rows), 8, n >> chunk_log2), dtype=torch.int32, device=values.device)
    for ci, row in enumerate(rows):
        cv = hash_leaves_u64_planes(values[row], prefixes[ci], out=cvs[ci])
        roots[ci] = _chunk_roots(cv, chunk_log2)
    return cvs, roots


def columns_commit_device(values: torch.Tensor, prefixes: Sequence[bytes], chunk_log2: int):
    """columns_commit_from_planes over every row of `values` (int64 [C, n])."""
    return columns_commit_from_planes(values, prefixes, chunk_log2)


def columns_commit_roots_scan(values: torch.Tensor, prefixes: Sequence[bytes],
                              chunk_log2: int, idx=None, seg_log2: int = 16):
    """Memory-bounded chunk roots: the same roots as columns_commit_from_planes
    but no leaf-CV buffer; each column is hashed 2^seg_log2 rows at a time and
    only the chunk roots are kept. Openings then recompute the queried chunks
    (chunk_paths_from_planes / chunk_paths_from_ranges).
    Returns roots int32 [C, 8, n_chunks] on the device."""
    rows = _select(values, prefixes, idx)
    n = values.shape[1]
    seg = 1 << min(seg_log2, n.bit_length() - 1)
    assert n % seg == 0 and seg >= (1 << chunk_log2)
    roots = torch.empty((len(rows), 8, n >> chunk_log2), dtype=torch.int32, device=values.device)
    for ci, row in enumerate(rows):
        for s in range(0, n, seg):
            cv = hash_leaves_u64_planes(values[row, s : s + seg], prefixes[ci])
            roots[ci, :, s >> chunk_log2 : (s + seg) >> chunk_log2] = _chunk_roots(cv, chunk_log2)
    return roots


def croots_to_host(roots: torch.Tensor) -> np.ndarray:
    """Device int32 [C, 8, nc] chunk-root planes -> uint8 [C, nc, 32]."""
    r = roots.detach().cpu().numpy()
    c, _, nc = r.shape
    rows = np.ascontiguousarray(r.transpose(0, 2, 1)).astype("<u4", copy=False)
    return rows.view(np.uint8).reshape(c, nc, 32)


# -------------- device path extraction (openings without leaf pulls) --------


def _as_index(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)


def _paths_from_leaf_cvs(cur: torch.Tensor, cur_idx: torch.Tensor, chunk_log2: int):
    """cur: int32 [8, K * chunk] leaf CVs of K chunks side by side; cur_idx:
    int64 [K] index of the opened leaf inside each chunk. Each chunk's tree is
    built level by level and the sibling node gathered on the way.
    Returns (paths uint8 [K, chunk_log2, 32], roots uint8 [K, 32])."""
    k = cur_idx.shape[0]
    base = torch.arange(k, device=cur.device)
    paths: List[torch.Tensor] = []
    m = 1 << chunk_log2
    while m > 1:
        sib = base * m + (cur_idx ^ 1)
        paths.append(cur[:, sib])  # [8, K]
        cur = parent_level_planes(cur)
        cur_idx = cur_idx >> 1
        m >>= 1
    if paths:
        p = torch.stack(paths, dim=0).cpu().numpy()  # [L, 8, K]
        rows = np.ascontiguousarray(p.transpose(2, 0, 1)).astype("<u4", copy=False)
        paths8 = rows.view(np.uint8).reshape(k, chunk_log2, 32)
    else:
        paths8 = np.zeros((k, 0, 32), np.uint8)
    return paths8, cv_planes_to_bytes(cur)


def chunk_paths_device(cvs: torch.Tensor, cols, chunk_starts, idx_in_chunk, chunk_log2: int):
    """Inner-chunk Merkle paths for K (column, chunk, index) requests.

    cvs: int32 [C, 8, n] resident leaf CVs. cols / chunk_starts / idx_in_chunk:
    int sequences [K] (column, row offset of the chunk, index inside it).
    Each request's chunk tree is rebuilt level by level on the device and the
    sibling node gathered on the way; only the paths travel back.
    Returns (paths uint8 [K, chunk_log2, 32], roots uint8 [K, 32])."""
    k = len(chunk_starts)
    chunk = 1 << chunk_log2
    if k == 0:
        return np.zeros((0, chunk_log2, 32), np.uint8), np.zeros((0, 32), np.uint8)
    dev = cvs.device
    n = cvs.shape[2]
    # gather the K chunks' leaves: [8, K * chunk]
    offs = (_as_index(cols, dev) * (8 * n) + _as_index(chunk_starts, dev))[:, None] \
        + torch.arange(chunk, device=dev)[None, :]
    flat = cvs.reshape(-1)
    cur = torch.stack([flat[(offs + w * n).reshape(-1)] for w in range(8)], dim=0)
    return _paths_from_leaf_cvs(cur, _as_index(idx_in_chunk, dev), chunk_log2)


def _chunk_paths_from_values(vals: torch.Tensor, idx_in_chunk, prefixes: Sequence[bytes],
                             chunk_log2: int):
    """vals: int64 [K, chunk], request i's chunk of column values, hashed
    with prefixes[i]. Returns (paths, roots, values uint64 [K])."""
    k, chunk = vals.shape
    assert chunk == 1 << chunk_log2 and len(prefixes) == k
    dev = vals.device
    groups: dict = {}
    for i, p in enumerate(prefixes):
        groups.setdefault(p, []).append(i)
    cur = torch.empty((8, k, chunk), dtype=torch.int32, device=dev)
    for prefix, ids in groups.items():
        ids_t = _as_index(ids, dev)
        cv = hash_leaves_u64_planes(vals[ids_t].reshape(-1), prefix)
        cur[:, ids_t] = cv.reshape(8, len(ids), chunk)
    idx_t = _as_index(idx_in_chunk, dev)
    opened = vals[torch.arange(k, device=dev), idx_t]
    paths8, roots8 = _paths_from_leaf_cvs(cur.reshape(8, k * chunk), idx_t, chunk_log2)
    return paths8, roots8, opened.cpu().numpy().view(np.uint64)


def chunk_paths_from_planes(values: torch.Tensor, col_indices, chunk_starts, idx_in_chunk,
                            prefixes: Sequence[bytes], chunk_log2: int):
    """Openings against scan-committed columns: recompute each queried
    chunk's tree on the device from the resident column matrix (reference
    semantics: recompute-on-open, openings.rs:278-498 -- same paths, batched).

    values: int64 [C, n]; request i reads rows chunk_starts[i] .. + chunk of
    column col_indices[i] and is hashed with prefixes[i] (any lengths).
    Returns (paths uint8 [K, chunk_log2, 32], roots uint8 [K, 32], the opened
    values uint64 [K])."""
    k = len(chunk_starts)
    if k == 0:
        return (np.zeros((0, chunk_log2, 32), np.uint8), np.zeros((0, 32), np.uint8),
                np.zeros(0, np.uint64))
    dev = values.device
    n = values.shape[1]
    offs = (_as_index(col_indices, dev) * n + _as_index(chunk_starts, dev))[:, None] \
        + torch.arange(1 << chunk_log2, device=dev)[None, :]
    return _chunk_paths_from_values(values.reshape(-1)[offs], idx_in_chunk, prefixes, chunk_log2)


def chunk_paths_from_ranges(ranges: torch.Tensor, sel_s, col_indices, idx_in_chunk,
                            prefixes: Sequence[bytes], chunk_log2: int):
    """Like chunk_paths_from_planes but sourcing each request's chunk from
    pre-derived [S, C, chunk] range columns (DeviceColumns.derive_ranges):
    request i reads ranges[sel_s[i], col_indices[i]]. No resident [C, n]
    matrix is needed. Same return contract."""
    if len(sel_s) == 0:
        return (np.zeros((0, chunk_log2, 32), np.uint8), np.zeros((0, 32), np.uint8),
                np.zeros(0, np.uint64))
    dev = ranges.device
    vals = ranges[_as_index(sel_s, dev), _as_index(col_indices, dev)]
    return _chunk_paths_from_values(vals, idx_in_chunk, prefixes, chunk_log2)
