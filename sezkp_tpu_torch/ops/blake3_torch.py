"""Batched BLAKE3 on torch tensors, and Merkle work built on it.

Counterpart of sezkp_tpu/ops/blake3_pallas.py (the compression kernel and the
single-chunk chain kernel) and of the parts of sezkp_tpu/ops/blake3_jax.py
that the STARK v1 route and the fold line run: labeled leaf hashing, Merkle
parent levels, whole-column commitments (with resident leaf CVs, or roots
only), in-chunk opening paths (from resident CVs, or recomputed from column
values), and the hash of a batch of equal-length messages of up to one chunk
(1024 bytes).

On the STARK route every message is at most 64 bytes: one BLAKE3 compression
with flags CHUNK_START|CHUNK_END|ROOT and counter 0. Merkle parents are hashed
that way too (a 64-byte message), not with BLAKE3's PARENT flag. The fold
line's MAC and digest messages take up to 16 blocks.

Layouts. Message and digest words are ``torch.int32`` tensors holding u32 bit
patterns, word-major ("planes"): messages ``[16, N]`` (``[16 * nblocks, N]``
for the chain), chaining values ``[8, N]``. Field values are int64 tensors
(see goldilocks_torch).

**Kernel K1 ``blake3_compress``** (csrc/blake3_compress.cu) replaces the
Pallas kernel ``blake3_pallas._build``. :func:`compress` launches it for a
CUDA tensor and runs :func:`compress_plain` only for a CPU tensor. Bound on
an H100: 64 B read + 32 B written per message against the memory rate, and
680 32-bit integer instructions per message (224 adds, the three-input ones
counting once, 232 xors, 224 funnel-shift rotates) against the integer rate;
the integer rate is the nearer one, so the kernel keeps all 32 words in registers and
does nothing else. The message assembly and the even/odd
gather for parents stay plain tensor code around the kernel.

**Kernel K13 ``blake3_chunk_roots``** (csrc/blake3_chunk_roots.cu) replaces
no Pallas kernel: it is the column commitment that the JAX package composes
under jit (blake3_jax.columns_commit_*), as one launch for a whole matrix --
each value spliced behind its label prefix in registers, the leaves hashed,
every chunk tree reduced on chip (one block a tree), the leaf CVs written
when a buffer is given. :func:`chunk_roots` launches it for a CUDA tensor and
runs :func:`chunk_roots_plain`, the composition around K1 it replaces, only
for a CPU tensor; :func:`chunk_roots_model` is its schedule in tensor code.
The integer rate bounds it, as it does K1.

**Kernel K7 ``blake3_chain``** (csrc/blake3_chain.cu) replaces the Pallas
kernel ``blake3_pallas._build_chain``. :func:`hash_many_words` launches it for
a CUDA tensor and runs :func:`hash_many_words_plain` only for a CPU tensor.
Per message it reads 64 B per block once and writes 32 B; the chaining value
stays in registers between blocks. The integer rate bounds it from two blocks
up. :func:`hash_many_device` is the host-bytes entry around it: one upload,
padding and word transposition on the device, the kernel, one download.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import tracing
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


def compress_plain(m16: torch.Tensor, block_len: int, flags: int, out_words: int = 8, cv=None):
    """Plain PyTorch version of K1: int32 [16, N] -> int32 [out_words, N].
    Wrapping int32 adds, masked shifts; the 7 rounds unrolled in Python.
    `cv` is the input chaining value, int32 [8, N]; without it the IV.
    `block_len` is an int, or an int32 [N] tensor of one length a message."""
    assert m16.dtype == torch.int32 and m16.dim() == 2 and m16.shape[0] == 16
    n = m16.shape[1]
    msg = [m16[i] for i in range(16)]

    def c(x):
        return torch.full((n,), _s32(x), dtype=torch.int32, device=m16.device)

    v = ([c(IV[j]) for j in range(8)] if cv is None else [cv[j] for j in range(8)]) + [
        c(IV[0]), c(IV[1]), c(IV[2]), c(IV[3]), c(0), c(0),
        block_len if isinstance(block_len, torch.Tensor) else c(block_len), c(flags),
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


def _destination(out, words: int, m: torch.Tensor) -> torch.Tensor:
    """The kernel's output tensor: `out` if it is a contiguous int32
    [words, N] tensor on m's device (else an error), or a new one."""
    n = m.shape[1]
    if out is None:
        return torch.empty((words, n), dtype=torch.int32, device=m.device)
    if (
        out.dtype != torch.int32 or tuple(out.shape) != (words, n)
        or not out.is_contiguous() or out.device != m.device
    ):
        raise ValueError(f"out must be a contiguous int32 [{words}, N] tensor on the same device")
    return out


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
    out = _destination(out, out_words, m16)
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


# ------------------- single-chunk messages of any length --------------------

MAX_MSG_LEN = 1024  # one BLAKE3 chunk


def _nblocks(msg_len: int) -> int:
    if not 0 < msg_len <= MAX_MSG_LEN:
        raise ValueError("single-chunk messages only: 0 < msg_len <= 1024")
    return -(-msg_len // 64)


def hash_many_words_plain(m: torch.Tensor, msg_len: int) -> torch.Tensor:
    """Plain PyTorch version of K7: int32 [16 * nblocks, N] planes of the
    zero-padded messages + their byte length -> int32 [8, N] digest words.
    One compress_plain per block, the chaining value passed from block to block:
    CHUNK_START on block 0, CHUNK_END|ROOT and the tail's length on the last,
    length 64 on the others."""
    nblocks = _nblocks(msg_len)
    assert m.dtype == torch.int32 and m.dim() == 2 and m.shape[0] == 16 * nblocks
    cv = None
    for b in range(nblocks):
        last = b == nblocks - 1
        flags = (CHUNK_START if b == 0 else 0) | (CHUNK_END | ROOT if last else 0)
        blen = msg_len - 64 * (nblocks - 1) if last else 64
        cv = compress_plain(m[16 * b : 16 * b + 16], blen, flags, 8, cv=cv)
    return cv


def hash_many_words(m: torch.Tensor, msg_len: int, out=None) -> torch.Tensor:
    """K7 wrapper: int32 [16 * ceil(msg_len / 64), N] message planes ->
    int32 [8, N] digest words, 0 < msg_len <= 1024.

    CUDA tensor: launches the kernel (or raises). CPU tensor: plain version.
    `out` optionally names a contiguous [8, N] int32 destination."""
    nblocks = _nblocks(msg_len)
    if m.dtype != torch.int32 or m.dim() != 2 or m.shape[0] != 16 * nblocks:
        raise ValueError(f"hash_many_words of {msg_len}-byte messages takes an int32 "
                         f"[{16 * nblocks}, N] tensor")
    n = m.shape[1]
    if not m.is_cuda:
        res = hash_many_words_plain(m, msg_len)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if not m.is_contiguous():
        raise ValueError("hash_many_words takes a contiguous message tensor")
    out = _destination(out, 8, m)
    if n == 0:
        return out
    with torch.cuda.device(m.device):
        rc = _kernels.lib().sezkp_blake3_chain(
            m.data_ptr(), out.data_ptr(), n, nblocks, msg_len - 64 * (nblocks - 1),
            _kernels.stream_ptr(),
        )
    _kernels.check(rc, "blake3_chain")
    hash_many_words.launches += 1
    return out


hash_many_words.launches = 0


def messages_to_planes(messages: np.ndarray, device) -> torch.Tensor:
    """uint8 [N, L] messages (host) -> int32 [16 * nblocks, N] word planes on
    `device`: one upload of the bytes as they are, then the zero-padding of
    each row to whole blocks and the row-major -> word-major transposition on
    the device (on the host both grow with the batch and cost more than the
    hash). Words are little-endian."""
    msgs = np.ascontiguousarray(messages, dtype=np.uint8)
    n, length = msgs.shape
    width = 64 * _nblocks(length)
    rows = torch.from_numpy(msgs).to(device)
    if length != width:
        padded = torch.zeros((n, width), dtype=torch.uint8, device=rows.device)
        padded[:, :length] = rows
        rows = padded
    return rows.view(torch.int32).t().contiguous()  # [N, 16 * nblocks] -> planes


def hash_many_device(messages: np.ndarray, device=None) -> np.ndarray:
    """Device counterpart of crypto.blake3.hash_many for a batch of
    single-chunk messages: uint8 [N, L], 0 < L <= 1024 -> uint8 [N, 32].

    `device=None` is the CUDA card and raises without one; "cpu" runs the
    plain version. One upload, K7, one (synchronising) download."""
    planes = messages_to_planes(messages, _kernels.resolve_device(device))
    return cv_planes_to_bytes(hash_many_words(planes, messages.shape[1]))


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
        # transposed where the planes lie, so a device tensor comes down as rows
        rows = cv.detach().t().contiguous().cpu().numpy()
    else:
        rows = np.ascontiguousarray(np.asarray(cv).T)
    rows = rows.astype("<u4", copy=False)
    return rows.view(np.uint8).reshape(rows.shape[0], 32)


# ------------- column commitments: K13 blake3_chunk_roots ------------------

SEG_LOG2 = 21
# the chunk depths K13 takes: the columns' (params.COL_CHUNK_LOG2) and the FRI's
CHUNK_ROOTS_LOG2 = (10, 11)
CHUNK_ROOTS_THREADS = 256  # K13's block, one a (column, chunk) tree
_TABLE_WORDS = 18  # K13's table: 16 prefix words, the prefix's length, the source row


def _chunk_roots(cv: torch.Tensor, chunk_log2: int) -> torch.Tensor:
    """Leaf CVs [8, m] -> the roots [8, m >> chunk_log2] of their chunk trees."""
    for _ in range(chunk_log2):
        cv = parent_level_planes(cv)
    return cv


def _select(values: torch.Tensor, prefixes: Sequence[bytes], idx, chunk_log2: int):
    """The selected rows (ints) and n; raises on a ragged n or a prefix
    count that is not the row count."""
    rows = list(range(values.shape[0])) if idx is None else [int(i) for i in idx]
    if len(prefixes) != len(rows):
        raise ValueError(f"{len(prefixes)} prefixes for {len(rows)} rows")
    n = values.shape[1]
    if n % (1 << chunk_log2):
        raise ValueError(f"n = {n} is not a multiple of the chunk, 2^{chunk_log2}")
    return rows, n


def _prefix_table(prefixes: Sequence[bytes], rows: Sequence[int]) -> np.ndarray:
    """K13's per-column table, int32 [C, 18]: the prefix's 16 little-endian
    words (zero past its end), its length in bytes, the row it commits."""
    table = np.zeros((len(rows), _TABLE_WORDS), dtype=np.uint32)
    for i, (prefix, row) in enumerate(zip(prefixes, rows)):
        if len(prefix) + 8 > 64:
            raise ValueError("a leaf is one block: prefixes of at most 56 bytes")
        table[i, :16] = _prefix_words(prefix)
        table[i, 16] = len(prefix)
        table[i, 17] = row
    return table.view(np.int32)


def chunk_roots_plain(values: torch.Tensor, prefixes: Sequence[bytes], chunk_log2: int,
                      idx=None, cvs: Optional[torch.Tensor] = None,
                      seg_log2: int = SEG_LOG2) -> torch.Tensor:
    """Plain version of K13: the composition it replaces, on K1 (a CUDA
    tensor) or compress_plain (a CPU tensor). Column by column: the leaf
    messages (leaf_messages), one compress, then one parent level (a gather
    of the even and odd nodes, one compress) for each of the chunk_log2
    levels. With `cvs` (int32 [C, 8, n]) the column's leaf CVs are written
    there; without, each column is hashed 2^seg_log2 rows at a time and only
    the chunk roots are kept. Returns roots int32 [C, 8, n >> chunk_log2]."""
    rows, n = _select(values, prefixes, idx, chunk_log2)
    roots = torch.empty((len(rows), 8, n >> chunk_log2), dtype=torch.int32, device=values.device)
    if cvs is not None:
        for ci, row in enumerate(rows):
            cv = hash_leaves_u64_planes(values[row], prefixes[ci], out=cvs[ci])
            roots[ci] = _chunk_roots(cv, chunk_log2)
        return roots
    seg = 1 << min(seg_log2, n.bit_length() - 1)
    assert n % seg == 0 and seg >= (1 << chunk_log2)
    for ci, row in enumerate(rows):
        for s in range(0, n, seg):
            cv = hash_leaves_u64_planes(values[row, s : s + seg], prefixes[ci])
            roots[ci, :, s >> chunk_log2 : (s + seg) >> chunk_log2] = _chunk_roots(cv, chunk_log2)
    return roots


def _check_depth(chunk_log2: int) -> None:
    if chunk_log2 not in CHUNK_ROOTS_LOG2:
        raise ValueError(f"K13 takes chunk depths {CHUNK_ROOTS_LOG2}, not {chunk_log2}")


def chunk_roots_model(values: torch.Tensor, prefixes: Sequence[bytes], chunk_log2: int,
                      idx=None, cvs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13's schedule in tensor code (csrc/blake3_chunk_roots.cu), every
    block at once: the same table (_prefix_table); thread t of the (column,
    chunk) block takes the leaf pairs p = t + j * T in turn, splices each
    value into the prefix words as the kernel's funnel shifts do (words
    word0, word0 + 1, word0 + 2 of the prefix's length), hashes the two leaves
    and their parent, stores the leaf CVs at 2p, 2p + 1 and the parent at p
    of the shared level; the levels above are reduced in place, T parents at
    a time (the reads of a pass, then its writes), from 16 parents down by
    warp 0 alone. Same arguments and result as chunk_roots."""
    rows, n = _select(values, prefixes, idx, chunk_log2)
    _check_depth(chunk_log2)
    pairs, threads = 1 << (chunk_log2 - 1), CHUNK_ROOTS_THREADS
    dev = values.device
    table = torch.from_numpy(_prefix_table(prefixes, rows)).to(dev).to(torch.int64) & _M32
    cols, nchunks = len(rows), n >> chunk_log2
    pw, plen = table[:, :16], table[:, 16]
    word0, sh = (plen >> 2)[:, None, None], ((plen & 3) * 8)[:, None, None]
    vals = values[table[:, 17]].reshape(cols, nchunks, 2 * pairs)
    t = torch.arange(threads, device=dev)

    def hash_(m: List[torch.Tensor], block_len) -> torch.Tensor:
        """16 words [C, nchunks, K] -> CVs [8, C, nchunks, K]."""
        m16 = torch.stack([w.to(torch.int32) for w in m]).reshape(16, -1)
        if isinstance(block_len, torch.Tensor):
            block_len = block_len.expand(m[0].shape).reshape(-1).to(torch.int32)
        return compress_plain(m16, block_len, LEAF_FLAGS, 8).reshape(8, *m[0].shape)

    def leaf(x: torch.Tensor) -> torch.Tensor:
        lo, hi = x & _M32, (x >> 32) & _M32
        pw0 = pw.gather(1, word0[:, :, 0])[:, :, None]
        spliced = ((pw0 | (lo << sh)) & _M32,               # word0
                   ((hi << sh) | (lo >> (32 - sh))) & _M32,  # word0 + 1: hi when sh = 0
                   hi >> (32 - sh))                          # word0 + 2: 0 when sh = 0
        m = []
        for w in range(16):
            word = pw[:, w, None, None].expand(x.shape)
            for d in (2, 1, 0):
                word = torch.where(word0 + d == w, spliced[d], word)
            m.append(word)
        return hash_(m, plen[:, None, None] + 8)

    level = torch.empty((cols, nchunks, 8, pairs), dtype=torch.int32, device=dev)
    cv_view = None if cvs is None else cvs.view(cols, 8, nchunks, 2 * pairs)
    for j in range(pairs // threads):
        p = t + j * threads
        left, right = leaf(vals[:, :, 2 * p]), leaf(vals[:, :, 2 * p + 1])
        parent = hash_(list(left) + list(right), 64)
        level[:, :, :, p] = parent.permute(1, 2, 0, 3)
        if cv_view is not None:
            cv_view[:, :, :, 2 * p] = left.permute(1, 0, 2, 3)
            cv_view[:, :, :, 2 * p + 1] = right.permute(1, 0, 2, 3)

    roots = torch.empty((cols, 8, nchunks), dtype=torch.int32, device=dev)
    h = pairs // 2
    while h >= 1:
        width = threads if h >= 32 else 32  # the block's threads, or warp 0's lanes
        for q0 in range(0, h, width):
            q = q0 + t[:width]
            q = q[q < h]
            kids = level[:, :, :, 2 * q], level[:, :, :, 2 * q + 1]  # the reads, then a barrier
            parent = hash_([kids[0][:, :, w] for w in range(8)] + [kids[1][:, :, w] for w in range(8)], 64)
            if h == 1:
                roots[:] = parent[:, :, :, 0].permute(1, 0, 2)
            else:
                level[:, :, :, q] = parent.permute(1, 2, 0, 3)
        h //= 2
    return roots


def chunk_roots(values: torch.Tensor, prefixes: Sequence[bytes], chunk_log2: int, idx=None,
                cvs: Optional[torch.Tensor] = None, seg_log2: int = SEG_LOG2) -> torch.Tensor:
    """K13 wrapper: the chunk roots int32 [C, 8, n >> chunk_log2] of the
    columns idx (default: every row) of values (int64 [C_all, n], n a
    multiple of 2^chunk_log2), column i's leaves hashed with prefixes[i], and
    with `cvs` (int32 [C, 8, n], contiguous) their leaf CVs written there.

    CUDA tensor: one launch of K13 (or raises); the per-column table goes
    up from pinned memory without a sync; chunk_log2 in CHUNK_ROOTS_LOG2,
    values with unit column stride. It adds the (column, chunk) trees built
    to the recorded prove's counter `blake3.chunk_trees`. CPU tensor:
    chunk_roots_plain (`seg_log2` shapes its roots-only scan)."""
    rows, n = _select(values, prefixes, idx, chunk_log2)
    if not values.is_cuda:
        return chunk_roots_plain(values, prefixes, chunk_log2, idx, cvs, seg_log2)
    _check_depth(chunk_log2)
    if values.dtype != torch.int64 or values.dim() != 2 or values.stride(1) != 1:
        raise ValueError("chunk_roots takes int64 [C, n] values with unit column stride")
    cols, dev = len(rows), values.device
    if cvs is not None and (
        cvs.dtype != torch.int32 or tuple(cvs.shape) != (cols, 8, n)
        or not cvs.is_contiguous() or cvs.device != dev
    ):
        raise ValueError(f"cvs must be a contiguous int32 [{cols}, 8, {n}] tensor on the values' device")
    if cols > 65535:
        raise ValueError("K13 takes at most 65535 columns a launch")
    roots = torch.empty((cols, 8, n >> chunk_log2), dtype=torch.int32, device=dev)
    if cols == 0:
        return roots
    table = torch.from_numpy(_prefix_table(prefixes, rows)).pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        rc = _kernels.lib().sezkp_blake3_chunk_roots(
            values.data_ptr(), values.stride(0), n, chunk_log2, cols, table.data_ptr(),
            roots.data_ptr(), None if cvs is None else cvs.data_ptr(), _kernels.stream_ptr(),
        )
    _kernels.check(rc, "blake3_chunk_roots")
    chunk_roots.launches += 1
    tracing.count("blake3.chunk_trees", cols * (n >> chunk_log2))
    return roots


chunk_roots.launches = 0


def columns_commit_from_planes(values: torch.Tensor, prefixes: Sequence[bytes],
                               chunk_log2: int, idx=None):
    """Hash and chunk-commit columns of a device-resident matrix in place
    (no copy of the values is made or uploaded).

    values: int64 [C_all, n] field tensor, n a multiple of 2^chunk_log2.
    idx: optional row selection (ints [C]); without it every row, in order.
    prefixes: one byte string per selected row (any lengths).
    Returns (cvs int32 [C, 8, n] leaf CV planes, resident on the device;
    roots int32 [C, 8, n_chunks] chunk-root planes, also on the device).
    On the card one K13 launch (chunk_roots); on the CPU the plain
    composition, one column at a time."""
    rows, n = _select(values, prefixes, idx, chunk_log2)
    cvs = torch.empty((len(rows), 8, n), dtype=torch.int32, device=values.device)
    return cvs, chunk_roots(values, prefixes, chunk_log2, idx, cvs=cvs)


def columns_commit_roots_scan(values: torch.Tensor, prefixes: Sequence[bytes],
                              chunk_log2: int, idx=None, seg_log2: int = SEG_LOG2,
                              counter: Optional[str] = None):
    """Memory-bounded chunk roots: the same roots as columns_commit_from_planes
    but no leaf-CV buffer. Openings then recompute the queried chunks
    (chunk_tree_planes).
    On the card one K13 launch, which keeps no leaf CV or message off chip;
    it adds 1 to the recorded prove's counter `counter` when one is named
    (utils/tracing.count). On the CPU the plain composition hashes each
    column 2^seg_log2 rows at a time (1 + chunk_log2 compress calls a
    segment) and adds its C * n / 2^min(seg_log2, log2 n) segments to the
    counter (C the selected rows): 59 * 8 = 472 for the columns of T = 2^24.
    Returns roots int32 [C, 8, n_chunks] on the device."""
    rows, n = _select(values, prefixes, idx, chunk_log2)
    if counter is not None:
        segments = len(rows) * (n >> min(seg_log2, n.bit_length() - 1))
        tracing.count(counter, 1 if values.is_cuda else segments)
    return chunk_roots(values, prefixes, chunk_log2, idx, seg_log2=seg_log2)


def croots_to_host(roots: torch.Tensor) -> np.ndarray:
    """Device int32 [C, 8, nc] chunk-root planes -> uint8 [C, nc, 32]."""
    r = roots.detach().cpu().numpy()
    c, _, nc = r.shape
    rows = np.ascontiguousarray(r.transpose(0, 2, 1)).astype("<u4", copy=False)
    return rows.view(np.uint8).reshape(c, nc, 32)


# -------------- device path extraction (openings without leaf pulls) --------


def _as_index(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)


def _path_planes_from_leaf_cvs(cur: torch.Tensor, cur_idx: torch.Tensor, chunk_log2: int, rows=None):
    """cur: int32 [8, K * chunk] leaf CVs of K chunks side by side; cur_idx:
    int64 [R] index of the opened leaf inside chunk rows[R] (default: one
    request a chunk, R = K, rows = 0 .. K-1). Each chunk's tree is built level
    by level on the device (chunks are aligned, so no sibling pair crosses
    one) and the sibling nodes gathered on the way.
    Returns (the sibling nodes int32 [chunk_log2, 8, R] or None when
    chunk_log2 is 0, the chunk roots' CV planes [8, K])."""
    k = cur_idx.shape[0]
    base = torch.arange(k, device=cur.device) if rows is None else rows
    paths: List[torch.Tensor] = []
    m = 1 << chunk_log2
    while m > 1:
        sib = base * m + (cur_idx ^ 1)
        paths.append(cur[:, sib])  # [8, R]
        cur = parent_level_planes(cur)
        cur_idx = cur_idx >> 1
        m >>= 1
    return (torch.stack(paths, dim=0) if paths else None), cur


def path_planes_to_bytes(planes: Optional[torch.Tensor], k: int, chunk_log2: int) -> np.ndarray:
    """Sibling nodes int32 [chunk_log2, 8, K] (None when chunk_log2 is 0) ->
    the paths uint8 [K, chunk_log2, 32]: one device->host copy."""
    if planes is None:
        return np.zeros((k, 0, 32), np.uint8)
    p = planes.cpu().numpy()  # [L, 8, K]
    rows = np.ascontiguousarray(p.transpose(2, 0, 1)).astype("<u4", copy=False)
    return rows.view(np.uint8).reshape(k, chunk_log2, 32)


def chunk_path_planes(cvs: torch.Tensor, cols: torch.Tensor, chunk_starts: torch.Tensor,
                      idx_in_chunk: torch.Tensor, chunk_log2: int):
    """Inner-chunk Merkle paths for K (column, chunk, index) requests against
    resident leaf CVs: cvs int32 [C, 8, n]; cols, chunk_starts, idx_in_chunk
    int64 [K] tensors on cvs' device (column, row offset of the chunk, index
    inside it). Each request's chunk tree is rebuilt level by level and the
    sibling node gathered on the way. Returns (the sibling nodes int32
    [chunk_log2, 8, K] or None, the chunk roots' CV planes [8, K]).
    Launches only: nothing comes to the host."""
    n = cvs.shape[2]
    # gather the K chunks' leaves: [8, K * chunk]
    offs = (cols * (8 * n) + chunk_starts)[:, None] \
        + torch.arange(1 << chunk_log2, device=cvs.device)[None, :]
    flat = cvs.reshape(-1)
    cur = torch.stack([flat[(offs + w * n).reshape(-1)] for w in range(8)], dim=0)
    return _path_planes_from_leaf_cvs(cur, idx_in_chunk, chunk_log2)


def prefix_groups(prefixes: Sequence[bytes]):
    """Chunks grouped by their leaves' prefix: (order int64 [K], the chunk
    numbers group after group; bounds [(prefix, a, b)], group by group, whose
    chunks are order[a:b])."""
    groups: dict = {}
    for i, p in enumerate(prefixes):
        groups.setdefault(p, []).append(i)
    order = np.array([i for ids in groups.values() for i in ids], dtype=np.int64)
    bounds, a = [], 0
    for p, ids in groups.items():
        bounds.append((p, a, a + len(ids)))
        a += len(ids)
    return order, bounds


def chunk_tree_planes(vals: torch.Tensor, order: torch.Tensor, bounds, trees: torch.Tensor,
                      idx_in_chunk: torch.Tensor, chunk_log2: int):
    """Rebuild K chunk trees on the device and open R leaves in them: launches
    only, every index already on the device.

    vals: int64 [K, chunk], chunk k's values; its leaves are hashed with the
    prefix of its group (`order`, int64 [K], and `bounds`, from
    prefix_groups). Request r opens leaf idx_in_chunk[r] of chunk trees[r]
    (int64 [R] each). Returns (the sibling nodes int32 [chunk_log2, 8, R] or
    None, the chunk roots' CV planes [8, K], the opened values int64 [R])."""
    k, chunk = vals.shape
    assert chunk == 1 << chunk_log2
    cur = torch.empty((8, k, chunk), dtype=torch.int32, device=vals.device)
    for prefix, a, b in bounds:
        ids = order[a:b]
        cur[:, ids] = hash_leaves_u64_planes(vals[ids].reshape(-1), prefix).reshape(8, b - a, chunk)
    planes, roots = _path_planes_from_leaf_cvs(cur.reshape(8, k * chunk), idx_in_chunk, chunk_log2,
                                               rows=trees)
    return planes, roots, vals[trees, idx_in_chunk]
