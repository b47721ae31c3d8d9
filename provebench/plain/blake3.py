"""BLAKE3, from its specification (the BLAKE3 paper, section 2, and its
reference implementation's structure): one compression function, the chunk
chain, the tree of chunk chaining values, and the extendable output.

Two front ends of one compression:

- :class:`Hasher` hashes one message incrementally in pure Python, with
  ``copy`` and output of any length: the Fiat-Shamir transcript's hashes;
- :func:`hash_chunks` hashes many messages of one length of at most one chunk
  (1024 bytes) at once, in plain tensor code on the tensors' device: column
  and FRI leaves, tree nodes, manifest leaves. Words are int64 tensors that
  hold 32-bit values, word-major: ``[16 * blocks, N]`` in, ``[8, N]`` out.
"""

from __future__ import annotations

import struct
from typing import List

import torch

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
BLOCK_LEN, CHUNK_LEN = 64, 1024
M32 = 0xFFFFFFFF


def _schedule() -> List[List[int]]:
    """The message word each of the seven rounds reads at each position."""
    order, out = list(range(16)), []
    for _ in range(7):
        out.append(order)
        order = [order[p] for p in PERMUTATION]
    return out


SCHEDULE = _schedule()


# ---------------------------------------------------------------- pure Python


def _rotr(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & M32


def _g(v: list, a: int, b: int, c: int, d: int, x: int, y: int) -> None:
    v[a] = (v[a] + v[b] + x) & M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(cv, words, counter: int, block_len: int, flags: int) -> List[int]:
    """The compression function: 16 output words (the first 8 chain)."""
    v = list(cv) + list(IV[:4]) + [counter & M32, (counter >> 32) & M32, block_len, flags]
    for s in SCHEDULE:
        m = [words[i] for i in s]
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
    return [v[i] ^ v[i + 8] for i in range(8)] + [v[i + 8] ^ cv[i] for i in range(8)]


def _words(block: bytes) -> List[int]:
    return list(struct.unpack("<16I", block.ljust(BLOCK_LEN, b"\0")))


class _Output:
    """A compression not yet run: its chaining value, or the root's bytes."""

    def __init__(self, cv, words, counter, block_len, flags):
        self.cv, self.words, self.counter = cv, words, counter
        self.block_len, self.flags = block_len, flags

    def chaining_value(self) -> List[int]:
        return compress(self.cv, self.words, self.counter, self.block_len, self.flags)[:8]

    def root_bytes(self, n: int) -> bytes:
        out, block = bytearray(), 0
        while len(out) < n:
            w = compress(self.cv, self.words, block, self.block_len, self.flags | ROOT)
            out += struct.pack("<16I", *w)
            block += 1
        return bytes(out[:n])


class Hasher:
    """Incremental BLAKE3 of one message (unkeyed), with copies."""

    def __init__(self):
        self.stack: List[List[int]] = []   # chaining values of finished subtrees
        self.chunks = 0                     # chunks finished
        self._new_chunk()

    def _new_chunk(self) -> None:
        self.cv = list(IV)
        self.buf = b""
        self.blocks = 0                     # blocks compressed in this chunk

    def copy(self) -> "Hasher":
        h = Hasher.__new__(Hasher)
        h.stack = [list(c) for c in self.stack]
        h.chunks, h.cv, h.buf, h.blocks = self.chunks, list(self.cv), self.buf, self.blocks
        return h

    def _chunk_output(self) -> _Output:
        start = CHUNK_START if self.blocks == 0 else 0
        return _Output(self.cv, _words(self.buf), self.chunks, len(self.buf), start | CHUNK_END)

    def update(self, data: bytes) -> None:
        data = bytes(data)
        while data:
            if self.blocks * BLOCK_LEN + len(self.buf) == CHUNK_LEN:
                # the chunk is full and more input follows: close it
                cv = self._chunk_output().chaining_value()
                self.chunks += 1
                total = self.chunks
                while total & 1 == 0:
                    cv = compress(IV, self.stack.pop() + cv, 0, BLOCK_LEN, PARENT)[:8]
                    total >>= 1
                self.stack.append(cv)
                self._new_chunk()
            if len(self.buf) == BLOCK_LEN:
                start = CHUNK_START if self.blocks == 0 else 0
                self.cv = compress(self.cv, _words(self.buf), self.chunks, BLOCK_LEN, start)[:8]
                self.blocks += 1
                self.buf = b""
            take = min(BLOCK_LEN - len(self.buf), len(data))
            self.buf += data[:take]
            data = data[take:]

    def digest(self, n: int = 32) -> bytes:
        out = self._chunk_output()
        for cv in reversed(self.stack):
            out = _Output(list(IV), cv + out.chaining_value(), 0, BLOCK_LEN, PARENT)
        return out.root_bytes(n)


def hash_bytes(data: bytes, n: int = 32) -> bytes:
    h = Hasher()
    h.update(data)
    return h.digest(n)


# ---------------------------------------------------------------- tensors

_SLICE = 1 << 21   # messages a compression call takes at once


def _rotr_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & M32


def _g_t(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _rotr_t(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr_t(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr_t(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr_t(b ^ c, 7)
    return a, b, c, d


def compress_t(cv: torch.Tensor, m: torch.Tensor, block_len: int, flags: int) -> torch.Tensor:
    """The compression of N blocks at counter 0: cv [8, N], m [16, N] ->
    the chaining values [8, N]. The four G of a column step, and of a
    diagonal step, run as one [4, N] step."""
    n = m.shape[1]
    a, b = cv[:4], cv[4:]
    c = torch.tensor(IV[:4], dtype=torch.int64, device=m.device)[:, None].expand(4, n)
    d = torch.tensor([0, 0, block_len, flags], dtype=torch.int64, device=m.device)[:, None].expand(4, n)
    for s in SCHEDULE:
        a, b, c, d = _g_t(a, b, c, d, m[s[0:8:2]], m[s[1:8:2]])
        # diagonals: (0,5,10,15), (1,6,11,12), (2,7,8,13), (3,4,9,14)
        b, c, d = b.roll(-1, 0), c.roll(2, 0), d.roll(1, 0)
        a, b, c, d = _g_t(a, b, c, d, m[s[8:16:2]], m[s[9:16:2]])
        b, c, d = b.roll(1, 0), c.roll(-2, 0), d.roll(-1, 0)
    return torch.cat([a ^ c, b ^ d])


def hash_chunks(m: torch.Tensor, length: int) -> torch.Tensor:
    """BLAKE3 of N messages of `length` bytes (1..1024), each one chunk and
    the root: m [16 * blocks, N] words, zero past the message -> [8, N]."""
    assert 0 < length <= CHUNK_LEN
    blocks = -(-length // BLOCK_LEN)
    assert m.shape[0] == 16 * blocks
    n = m.shape[1]
    out = torch.empty((8, n), dtype=torch.int64, device=m.device)
    iv = torch.tensor(IV, dtype=torch.int64, device=m.device)[:, None]
    for lo in range(0, n, _SLICE):
        hi = min(n, lo + _SLICE)
        cv = iv.expand(8, hi - lo)
        for k in range(blocks):
            last = k == blocks - 1
            flags = (CHUNK_START if k == 0 else 0) | (CHUNK_END | ROOT if last else 0)
            blen = length - BLOCK_LEN * k if last else BLOCK_LEN
            cv = compress_t(cv, m[16 * k:16 * k + 16, lo:hi], blen, flags)
        out[:, lo:hi] = cv
    return out


def hash_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """BLAKE3(left || right) of 32-byte digests, [8, N] each -> [8, N]: a
    plain 64-byte message (the tree node of the v1 Merkle trees)."""
    return hash_chunks(torch.cat([left, right]), BLOCK_LEN)


def bytes_to_words(msgs: torch.Tensor) -> torch.Tensor:
    """uint8 [N, L] -> little-endian words [16 * blocks, N], zero-padded."""
    n, length = msgs.shape
    padded = torch.zeros((n, 64 * max(1, -(-length // 64))), dtype=torch.int64, device=msgs.device)
    padded[:, :length] = msgs.to(torch.int64)
    b = padded.view(n, -1, 4)
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)).T.contiguous()


def words_to_bytes(words: torch.Tensor) -> bytes:
    """[8, N] digest words -> N * 32 bytes, digest after digest."""
    w = words.T.contiguous().cpu()
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return b.to(torch.uint8).numpy().tobytes()
