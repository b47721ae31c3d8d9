"""Pure-Python BLAKE3 (reference implementation, from the public spec).

Used as the correctness oracle and as a fallback when the native C++ library
(sezkp_tpu_torch/native) is unavailable. Hot paths should go through
:mod:`sezkp_tpu_torch.crypto.blake3` which dispatches to the native library, or the
batched device kernels in :mod:`sezkp_tpu_torch.ops.blake3_torch` for on-device hashing.

The reference workspace uses the ``blake3`` Rust crate for every hash/MAC/
transcript (reference: crates/sezkp-crypto/src/lib.rs:35, crates/sezkp-merkle/
src/lib.rs:51). Bit-exactness with standard BLAKE3 is therefore mandatory.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

MASK32 = 0xFFFFFFFF

IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state: List[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state: List[int], m: List[int]) -> None:
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def compress(
    cv: Tuple[int, ...],
    block_words: List[int],
    counter: int,
    block_len: int,
    flags: int,
) -> List[int]:
    """The BLAKE3 compression function; returns the full 16-word state."""
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32,
        block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r != 6:
            m = [m[p] for p in MSG_PERMUTATION]
    for i in range(8):
        state[i] ^= state[i + 8]
        state[i + 8] ^= cv[i]
    return state


def _words_from_block(block: bytes) -> List[int]:
    if len(block) < BLOCK_LEN:
        block = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", block))


class _Output:
    """A pending chunk/parent output that can yield a CV or XOF bytes."""

    __slots__ = ("cv", "block_words", "counter", "block_len", "flags")

    def __init__(self, cv, block_words, counter, block_len, flags):
        self.cv = cv
        self.block_words = block_words
        self.counter = counter
        self.block_len = block_len
        self.flags = flags

    def chaining_value(self) -> Tuple[int, ...]:
        return tuple(
            compress(self.cv, self.block_words, self.counter, self.block_len, self.flags)[:8]
        )

    def root_bytes(self, n: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < n:
            words = compress(
                self.cv, self.block_words, counter, self.block_len, self.flags | ROOT
            )
            out += struct.pack("<16I", *words)
            counter += 1
        return bytes(out[:n])


class _ChunkState:
    __slots__ = ("cv", "chunk_counter", "block", "blocks_compressed")

    def __init__(self, key: Tuple[int, ...], chunk_counter: int):
        self.cv = key
        self.chunk_counter = chunk_counter
        self.block = b""
        self.blocks_compressed = 0

    def len(self) -> int:
        return BLOCK_LEN * self.blocks_compressed + len(self.block)

    def _start_flag(self) -> int:
        return CHUNK_START if self.blocks_compressed == 0 else 0

    def update(self, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            if len(self.block) == BLOCK_LEN:
                words = _words_from_block(self.block)
                self.cv = tuple(
                    compress(
                        self.cv, words, self.chunk_counter, BLOCK_LEN, self._start_flag()
                    )[:8]
                )
                self.blocks_compressed += 1
                self.block = b""
            want = BLOCK_LEN - len(self.block)
            take = min(want, len(data) - pos)
            self.block += data[pos : pos + take]
            pos += take

    def output(self) -> _Output:
        return _Output(
            self.cv,
            _words_from_block(self.block),
            self.chunk_counter,
            len(self.block),
            self._start_flag() | CHUNK_END,
        )


def _parent_output(left_cv, right_cv, key) -> _Output:
    block_words = list(left_cv) + list(right_cv)
    return _Output(key, block_words, 0, BLOCK_LEN, PARENT)


class Blake3:
    """Incremental BLAKE3 hasher (unkeyed), hashlib-like API with XOF."""

    def __init__(self) -> None:
        self.key = IV
        self.chunk = _ChunkState(IV, 0)
        self.cv_stack: List[Tuple[int, ...]] = []

    def copy(self) -> "Blake3":
        h = Blake3.__new__(Blake3)
        h.key = self.key
        c = _ChunkState(self.chunk.cv, self.chunk.chunk_counter)
        c.cv = self.chunk.cv
        c.block = self.chunk.block
        c.blocks_compressed = self.chunk.blocks_compressed
        h.chunk = c
        h.cv_stack = list(self.cv_stack)
        return h

    def _add_chunk_cv(self, new_cv: Tuple[int, ...], total_chunks: int) -> None:
        # Merge subtrees like a binary counter: one merge per trailing 0 bit.
        while total_chunks & 1 == 0:
            left = self.cv_stack.pop()
            new_cv = _parent_output(left, new_cv, self.key).chaining_value()
            total_chunks >>= 1
        self.cv_stack.append(new_cv)

    def update(self, data: bytes) -> "Blake3":
        pos = 0
        n = len(data)
        while pos < n:
            if self.chunk.len() == CHUNK_LEN:
                cv = self.chunk.output().chaining_value()
                total_chunks = self.chunk.chunk_counter + 1
                self._add_chunk_cv(cv, total_chunks)
                self.chunk = _ChunkState(self.key, self.chunk.chunk_counter + 1)
            want = CHUNK_LEN - self.chunk.len()
            take = min(want, n - pos)
            self.chunk.update(data[pos : pos + take])
            pos += take
        return self

    def _final_output(self) -> _Output:
        output = self.chunk.output()
        for left in reversed(self.cv_stack):
            output = _parent_output(left, output.chaining_value(), self.key)
        return output

    def digest(self, length: int = 32) -> bytes:
        return self._final_output().root_bytes(length)

    def hexdigest(self, length: int = 32) -> str:
        return self.digest(length).hex()


def blake3_hash(data: bytes, length: int = 32) -> bytes:
    return Blake3().update(data).digest(length)
