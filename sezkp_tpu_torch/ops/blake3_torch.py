"""Batched single-block BLAKE3 on torch tensors, and Merkle work built on it.

Counterpart of sezkp_tpu/ops/blake3_pallas.py (the compression kernel) and of
the part of sezkp_tpu/ops/blake3_jax.py that the STARK v1 route runs: labeled
leaf hashing, Merkle parent levels, whole-column commitments and in-chunk
opening paths.

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


def columns_commit_device(values: torch.Tensor, prefixes: Sequence[bytes], chunk_log2: int):
    """Hash and chunk-commit many columns on the device.

    values: int64 [C, n] field tensor, n a multiple of 2^chunk_log2.
    prefixes: C byte strings (any lengths).
    Returns (cvs int32 [C, 8, n] leaf CV planes, resident on the device;
    roots int32 [C, 8, n_chunks] chunk-root planes, also on the device)."""
    c, n = values.shape
    assert len(prefixes) == c
    assert n % (1 << chunk_log2) == 0
    n_chunks = n >> chunk_log2
    cvs = torch.empty((c, 8, n), dtype=torch.int32, device=values.device)
    roots = torch.empty((c, 8, n_chunks), dtype=torch.int32, device=values.device)
    for ci in range(c):
        cur = hash_leaves_u64_planes(values[ci], prefixes[ci], out=cvs[ci])
        for _ in range(chunk_log2):
            cur = parent_level_planes(cur)
        roots[ci] = cur
    return cvs, roots


def croots_to_host(roots: torch.Tensor) -> np.ndarray:
    """Device int32 [C, 8, nc] chunk-root planes -> uint8 [C, nc, 32]."""
    r = roots.detach().cpu().numpy()
    c, _, nc = r.shape
    rows = np.ascontiguousarray(r.transpose(0, 2, 1)).astype("<u4", copy=False)
    return rows.view(np.uint8).reshape(c, nc, 32)


# -------------- device path extraction (openings without leaf pulls) --------


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
    c, _, n = cvs.shape
    col_t = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=dev)
    start_t = torch.as_tensor(np.asarray(chunk_starts, dtype=np.int64), device=dev)
    cur_idx = torch.as_tensor(np.asarray(idx_in_chunk, dtype=np.int64), device=dev)
    # gather the K chunks' leaves: [8, K * chunk]
    offs = (col_t * (8 * n) + start_t)[:, None] + torch.arange(chunk, device=dev)[None, :]
    flat = cvs.reshape(-1)
    cur = torch.stack([flat[(offs + w * n).reshape(-1)] for w in range(8)], dim=0)
    base = torch.arange(k, device=dev)
    paths: List[torch.Tensor] = []
    m = chunk
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
