"""Columnar trace view + boundary/interface digests for STARK v1.

TPU-first redesign of crates/sezkp-stark/src/v1/columns.rs: the reference's
per-row Rust loops become whole-trace numpy constructions (heads are cumsums
over moves; offsets are broadcast block constants). Bit-decomposition aux
columns are NOT materialized — they are pure functions of the committed
columns and are folded directly into the vectorized AIR composition
(see air.py; the aux columns are never committed in the reference either,
columns_stream.rs:78-197).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ...core.types import BlockSummary
from ...crypto import blake3
from ...ops import goldilocks as G

SYM_BITS = 4
HEAD_BITS = 16
IFACE_WINDOW_STEPS = 32


@dataclass
class TraceColumns:
    """All committed columns as u64 field arrays.

    Scalars: [n]; per-tape: [tau, n]. Label order must match openings
    (reference: openings.rs:89-116).
    """

    n: int
    tau: int
    input_mv: np.ndarray  # [n]
    is_first: np.ndarray
    is_last: np.ndarray
    mv: np.ndarray  # [tau, n]
    write_flag: np.ndarray
    write_sym: np.ndarray
    head: np.ndarray
    win_len: np.ndarray
    in_off: np.ndarray
    out_off: np.ndarray

    @staticmethod
    def build(blocks: Sequence[BlockSummary]) -> "TraceColumns":
        n = sum(b.n_steps for b in blocks)
        tau = blocks[0].tau if blocks else 0

        input_mv = np.zeros(n, dtype=np.uint64)
        is_first = np.zeros(n, dtype=np.uint64)
        is_last = np.zeros(n, dtype=np.uint64)
        mv = np.zeros((tau, n), dtype=np.uint64)
        write_flag = np.zeros((tau, n), dtype=np.uint64)
        write_sym = np.zeros((tau, n), dtype=np.uint64)
        head = np.zeros((tau, n), dtype=np.uint64)
        win_len = np.zeros((tau, n), dtype=np.uint64)
        in_off = np.zeros((tau, n), dtype=np.uint64)
        out_off = np.zeros((tau, n), dtype=np.uint64)

        row = 0
        for b in blocks:
            ln = b.n_steps
            if ln == 0:
                continue
            sl = slice(row, row + ln)
            ml = b.movement_log
            is_first[row] = 1
            is_last[row + ln - 1] = 1
            input_mv[sl] = G.from_i64(ml.input_mv.astype(np.int64))

            tmv = ml.tape_mv.astype(np.int64).T  # [tau, ln]
            mv[:, sl] = G.from_i64(tmv)
            write_flag[:, sl] = ml.write_flag.T.astype(np.uint64)
            write_sym[:, sl] = ml.write_sym.T.astype(np.uint64)
            # move-then-write: head is post-move, relative to WINDOW-LEFT
            # (entry sits at off_in). Deliberate fix vs the reference:
            # columns.rs:298-315 anchors head at the entry position, which
            # contradicts its own AIR (air.rs:119-136 boundary terms and the
            # head/slack range checks both assume window-left anchoring), so
            # reference-honest proofs fail verification whenever a query row
            # lands in a block whose window extends left of the entry. See
            # docs/parity.md.
            head[:, sl] = G.from_i64(
                np.cumsum(tmv, axis=1) + b.head_in_offsets.astype(np.int64)[:, None]
            )
            wl = (np.abs(b.windows[:, 1] - b.windows[:, 0]) + 1).astype(np.uint64)
            win_len[:, sl] = wl[:, None]
            in_off[:, sl] = b.head_in_offsets.astype(np.uint64)[:, None]
            out_off[:, sl] = b.head_out_offsets.astype(np.uint64)[:, None]
            row += ln

        return TraceColumns(
            n=n,
            tau=tau,
            input_mv=input_mv,
            is_first=is_first,
            is_last=is_last,
            mv=mv,
            write_flag=write_flag,
            write_sym=write_sym,
            head=head,
            win_len=win_len,
            in_off=in_off,
            out_off=out_off,
        )

    # ------------------------- label plumbing --------------------------------

    def column_by_label(self, label: str) -> np.ndarray:
        if label == "input_mv":
            return self.input_mv
        if label == "is_first":
            return self.is_first
        if label == "is_last":
            return self.is_last
        name, _, idx = label.rpartition("_")
        r = int(idx)
        if name == "mv":
            return self.mv[r]
        if name == "wflag":
            return self.write_flag[r]
        if name == "wsym":
            return self.write_sym[r]
        if name == "head":
            return self.head[r]
        if name == "winlen":
            return self.win_len[r]
        if name == "in":  # in_off_{r}
            raise KeyError(label)
        if name == "in_off":
            return self.in_off[r]
        if name == "out_off":
            return self.out_off[r]
        raise KeyError(label)


def all_labels(tau: int) -> List[str]:
    """Canonical public label order (reference: openings.rs:89-116)."""
    out = ["input_mv", "is_first", "is_last"]
    for prefix in ("mv", "wflag", "wsym", "head", "winlen", "in_off", "out_off"):
        out += [f"{prefix}_{r}" for r in range(tau)]
    return out


# ---------------------------------------------------------------------------
# Interface / boundary digests (reference: columns.rs:51-213)
# ---------------------------------------------------------------------------


def _boundary_rows_bytes(block: BlockSummary, head: bool, k: int) -> bytes:
    """Per-step (mv i32, wflag u32, wsym u32) LE triples over first/last k steps,
    tape-major within each step."""
    ml = block.movement_log
    take = min(IFACE_WINDOW_STEPS, k, ml.n_steps)
    if take == 0:
        return b""
    if head:
        sl = slice(0, take)
    else:
        sl = slice(ml.n_steps - take, ml.n_steps)
    mvs = ml.tape_mv[sl].astype("<i4")  # [take, tau]
    wf = ml.write_flag[sl].astype("<u4")
    ws = ml.write_sym[sl].astype("<u4")
    tri = np.stack([mvs.view("<u4"), wf, ws], axis=2)  # [take, tau, 3]
    return tri.astype("<u4").tobytes()


def _offsets_bytes(block: BlockSummary) -> bytes:
    """(head_in as i32, head_out as i32) per tape, interleaved."""
    tau = block.tau
    arr = np.empty((tau, 2), dtype="<i4")
    arr[:, 0] = block.head_in_offsets.astype(np.int64).astype("<i4")
    arr[:, 1] = block.head_out_offsets.astype(np.int64).astype("<i4")
    return arr.tobytes()


def interface_boundary_digest(left: BlockSummary, right: BlockSummary) -> bytes:
    tau = left.tau
    h = blake3.Hasher()
    h.update(b"sezkp/iface/v1")
    h.update(np.uint32(tau).tobytes())
    # static offsets: per tape (left.in, left.out, right.in, right.out) as i32
    arr = np.empty((tau, 4), dtype="<i4")
    arr[:, 0] = left.head_in_offsets.astype(np.int64).astype("<i4")
    arr[:, 1] = left.head_out_offsets.astype(np.int64).astype("<i4")
    arr[:, 2] = right.head_in_offsets.astype(np.int64).astype("<i4")
    arr[:, 3] = right.head_out_offsets.astype(np.int64).astype("<i4")
    h.update(arr.tobytes())
    h.update(_boundary_rows_bytes(left, head=False, k=IFACE_WINDOW_STEPS))
    h.update(_boundary_rows_bytes(right, head=True, k=IFACE_WINDOW_STEPS))
    return h.digest(32)


def boundary_left_tail_digest(block: BlockSummary, k: int) -> bytes:
    h = blake3.Hasher()
    h.update(b"sezkp/iface/left_tail/v1")
    h.update(np.uint32(block.tau).tobytes())
    h.update(_offsets_bytes(block))
    h.update(_boundary_rows_bytes(block, head=False, k=k))
    return h.digest(32)


def boundary_right_head_digest(block: BlockSummary, k: int) -> bytes:
    h = blake3.Hasher()
    h.update(b"sezkp/iface/right_head/v1")
    h.update(np.uint32(block.tau).tobytes())
    h.update(_offsets_bytes(block))
    h.update(_boundary_rows_bytes(block, head=True, k=k))
    return h.digest(32)
