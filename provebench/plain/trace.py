"""A trace's blocks and its manifest root: the inputs a prover holds.

- The partition (upstream `crates/sezkp-trace/src/partition.rs`): blocks of
  `b` steps; in each, a tape's head starts at 0 and moves after each step;
  the window runs from the least to the largest position reached, 0
  included; the entry offset is -left, the exit offset the last position
  - left; the input head is counted from the trace's start.
- The manifest (upstream `crates/sezkp-merkle`): BLAKE3 of each block's
  canonical leaf (version u16, block_id u32, step_lo u64, step_hi u64,
  ctrl_in u16, ctrl_out u16, in_head_in i64, in_head_out i64, tau u64, the
  windows' (left, right) i64 pairs, the entry offsets u32, the exit offsets
  u32, the step count u64; little-endian, no framing), and the Merkle root of
  those over BLAKE3(left || right), an odd node promoted unchanged.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from . import blake3
from .stark_v1 import Trees


@dataclass
class Log:
    input_mv: np.ndarray      # int8 [n]
    tape_mv: np.ndarray       # int8 [n, tau]
    write_flag: np.ndarray    # bool [n, tau]
    write_sym: np.ndarray     # uint16 [n, tau]


@dataclass
class Block:
    version: int
    block_id: int
    step_lo: int
    step_hi: int
    ctrl_in: int
    ctrl_out: int
    in_head_in: int
    in_head_out: int
    windows: np.ndarray           # int64 [tau, 2]
    head_in_offsets: np.ndarray   # uint32 [tau]
    head_out_offsets: np.ndarray  # uint32 [tau]
    movement_log: Log
    pre_tags: List[bytes] = field(default_factory=list)
    post_tags: List[bytes] = field(default_factory=list)

    @property
    def n_steps(self) -> int:
        return self.step_hi - self.step_lo + 1

    @property
    def tau(self) -> int:
        return self.windows.shape[0]


def partition(log: Log, b: int) -> List[Block]:
    t, tau = log.tape_mv.shape
    in_pos = np.concatenate([[0], np.cumsum(log.input_mv, dtype=np.int64)])
    out = []
    for k, lo in enumerate(range(0, t, b)):
        hi = min(lo + b, t)
        pos = np.cumsum(log.tape_mv[lo:hi], axis=0, dtype=np.int64)
        left = np.minimum(pos.min(axis=0), 0)
        right = np.maximum(pos.max(axis=0), 0)
        out.append(Block(
            version=1, block_id=k + 1, step_lo=lo + 1, step_hi=hi, ctrl_in=0, ctrl_out=0,
            in_head_in=int(in_pos[lo]), in_head_out=int(in_pos[hi]),
            windows=np.stack([left, right], axis=1),
            head_in_offsets=(-left).astype(np.uint32),
            head_out_offsets=(pos[-1] - left).astype(np.uint32),
            movement_log=Log(log.input_mv[lo:hi], log.tape_mv[lo:hi],
                             log.write_flag[lo:hi], log.write_sym[lo:hi]),
            pre_tags=[bytes(16)] * tau, post_tags=[bytes(16)] * tau,
        ))
    return out


def leaf_bytes(b: Block) -> bytes:
    return b"".join([
        struct.pack("<HIQQHHqqQ", b.version, b.block_id, b.step_lo, b.step_hi, b.ctrl_in,
                    b.ctrl_out, b.in_head_in, b.in_head_out, b.tau),
        np.ascontiguousarray(b.windows, dtype="<i8").tobytes(),
        np.ascontiguousarray(b.head_in_offsets, dtype="<u4").tobytes(),
        np.ascontiguousarray(b.head_out_offsets, dtype="<u4").tobytes(),
        struct.pack("<Q", b.n_steps),
    ])


def manifest_root(blocks: List[Block]) -> bytes:
    msgs = [leaf_bytes(b) for b in blocks]
    assert len({len(m) for m in msgs}) <= 1, "blocks of one trace have one tape count"
    if not msgs:
        return bytes(32)
    raw = torch.frombuffer(bytearray(b"".join(msgs)), dtype=torch.uint8).view(len(msgs), -1)
    leaves = blake3.hash_chunks(blake3.bytes_to_words(raw), raw.shape[1])
    return blake3.words_to_bytes(Trees(leaves[:, None]).roots())
