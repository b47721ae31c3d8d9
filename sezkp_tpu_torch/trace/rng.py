"""Bit-exact reimplementation of Rust `rand` 0.9 `StdRng` (ChaCha12).

The reference trace generator is `StdRng::seed_from_u64(42)` with
`random_range` / `random_bool` draws (reference: crates/sezkp-trace/src/
generator.rs:38-73, rand 0.9.2 per Cargo.lock). To reproduce its traces we
implement:

- rand_core ``seed_from_u64`` (PCG32-based seed expansion)
- ChaCha12 block generation with rand_chacha's 4-block (64-word) buffer
- rand_core ``BlockRng`` next_u32/next_u64 word-consumption discipline
- uniform integer sampling (widening-multiply rejection) and Bernoulli

Parity is asserted in tests against the checked-in golden `blocks.cbor`.
"""

from __future__ import annotations

import struct
from typing import List

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def seed_from_u64(state: int) -> bytes:
    """rand_core SeedableRng::seed_from_u64 — PCG32 expansion to 32 bytes."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    for _ in range(8):
        state = (state * MUL + INC) & MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32
        out += struct.pack("<I", x)
    return bytes(out)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _chacha_block(key_words, counter: int, nonce_words, rounds: int) -> List[int]:
    c = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    state = [
        c[0], c[1], c[2], c[3],
        *key_words,
        counter & MASK32, (counter >> 32) & MASK32,
        nonce_words[0], nonce_words[1],
    ]
    x = list(state)

    def qr(a, b, cc, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[cc] = (x[cc] + x[d]) & MASK32
        x[b] = _rotl(x[b] ^ x[cc], 12)
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[cc] = (x[cc] + x[d]) & MASK32
        x[b] = _rotl(x[b] ^ x[cc], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + state[i]) & MASK32 for i in range(16)]


class ChaChaRng:
    """ChaCha-based RNG with rand_chacha's BlockRng semantics."""

    BUF_BLOCKS = 4  # rand_chacha generates 4 blocks (64 words) per refill

    def __init__(self, seed32: bytes, rounds: int = 12):
        assert len(seed32) == 32
        self.key = list(struct.unpack("<8I", seed32))
        self.nonce = [0, 0]
        self.rounds = rounds
        self.block_counter = 0  # counts 64-byte blocks
        self.buf: List[int] = []
        self.index = 64  # force refill on first use

    @classmethod
    def std_rng(cls, seed_u64: int) -> "ChaChaRng":
        return cls(seed_from_u64(seed_u64), rounds=12)

    def _refill(self) -> None:
        words: List[int] = []
        for i in range(self.BUF_BLOCKS):
            words += _chacha_block(
                self.key, self.block_counter + i, self.nonce, self.rounds
            )
        self.block_counter += self.BUF_BLOCKS
        self.buf = words
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= 64:
            self._refill()
        v = self.buf[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        # rand_core BlockRng::next_u64 word-pairing discipline.
        if self.index < 63:
            lo = self.buf[self.index] if self.buf else None
            if lo is None:
                self._refill()
            lo = self.buf[self.index]
            hi = self.buf[self.index + 1]
            self.index += 2
            return (hi << 32) | lo
        if self.index >= 64:
            self._refill()
            lo, hi = self.buf[0], self.buf[1]
            self.index = 2
            return (hi << 32) | lo
        # index == 63: straddle refill
        lo = self.buf[63]
        self._refill()
        hi = self.buf[0]
        self.index = 1
        return (hi << 32) | lo

    # ---------------- rand 0.9 distribution sampling ----------------------

    def _canon_u32(self, rng_size: int) -> int:
        """rand 0.9 UniformInt::sample_single_inclusive (Canon's method) for
        types whose sample type is u32 (i8..i32/u8..u32): one widening
        multiply, plus a single bias-correction draw with probability
        ~range/2^32."""
        v = self.next_u32()
        prod = v * rng_size
        result, lo_order = prod >> 32, prod & MASK32
        if lo_order > ((-rng_size) & MASK32):
            new_hi = (self.next_u32() * rng_size) >> 32
            carry = 1 if lo_order + new_hi > MASK32 else 0
            result += carry
        return result

    def random_range_u32(self, low: int, high_incl: int) -> int:
        rng_size = (high_incl - low + 1) & MASK32
        if rng_size == 0:
            return self.next_u32()
        return (low + self._canon_u32(rng_size)) & MASK32

    def random_range_u16(self, low: int, high_incl: int) -> int:
        rng_size = (high_incl - low + 1) & 0xFFFF
        if rng_size == 0:
            return self.next_u32() & 0xFFFF
        return (low + self._canon_u32(rng_size)) & 0xFFFF

    def random_bool(self, p: float) -> bool:
        """Bernoulli: p_int = (p * 2^64) as u64; accept iff next_u64 < p_int."""
        p_int = int(p * float(1 << 64))
        if p_int > MASK64:
            return True
        return self.next_u64() < p_int
