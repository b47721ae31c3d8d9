"""Streaming columnar view: per-chunk column matrices without full columns.

Equivalent of crates/sezkp-stark/src/v1/columns_stream.rs (per-row snapshots)
re-shaped for batch hashing: instead of one row at a time we emit one *chunk*
of rows at a time as a [n_cols, chunk] u64 matrix, still touching only O(b)
blocks and O(chunk) memory. Values are bit-identical to TraceColumns.build.
Copied from sezkp_tpu/stark/v1/columns_stream.py (numpy host code).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from ...core.types import BlockSummary
from ...ops import goldilocks as G


def block_column_matrix(b: BlockSummary) -> np.ndarray:
    """All committed column values for one block: u64 [n_cols, len]."""
    tau = b.tau
    ln = b.n_steps
    ml = b.movement_log
    out = np.zeros((3 + 7 * tau, ln), dtype=np.uint64)
    out[0] = G.from_i64(ml.input_mv.astype(np.int64))
    if ln:
        out[1, 0] = 1  # is_first
        out[2, ln - 1] = 1  # is_last
    tmv = ml.tape_mv.astype(np.int64).T
    base = 3
    out[base : base + tau] = G.from_i64(tmv)
    base += tau
    out[base : base + tau] = ml.write_flag.T.astype(np.uint64)
    base += tau
    out[base : base + tau] = ml.write_sym.T.astype(np.uint64)
    base += tau
    # head anchored at window-left (entry = off_in); see columns.py for the
    # deliberate deviation from the reference's entry-anchored heads.
    out[base : base + tau] = G.from_i64(
        np.cumsum(tmv, axis=1) + b.head_in_offsets.astype(np.int64)[:, None]
    )
    base += tau
    wl = (np.abs(b.windows[:, 1] - b.windows[:, 0]) + 1).astype(np.uint64)
    out[base : base + tau] = wl[:, None]
    base += tau
    out[base : base + tau] = b.head_in_offsets.astype(np.uint64)[:, None]
    base += tau
    out[base : base + tau] = b.head_out_offsets.astype(np.uint64)[:, None]
    return out


def stream_column_chunks(
    blocks: Sequence[BlockSummary], chunk_size: int
) -> Iterator[np.ndarray]:
    """Yield [n_cols, k] u64 matrices with k == chunk_size except the last."""
    pending: List[np.ndarray] = []
    have = 0
    for b in blocks:
        m = block_column_matrix(b)
        pos = 0
        ln = m.shape[1]
        while pos < ln:
            take = min(chunk_size - have, ln - pos)
            pending.append(m[:, pos : pos + take])
            have += take
            pos += take
            if have == chunk_size:
                yield np.concatenate(pending, axis=1)
                pending, have = [], 0
    if have:
        yield np.concatenate(pending, axis=1)


def rows_of_range(
    blocks: Sequence[BlockSummary], start: int, end: int
) -> np.ndarray:
    """Recompute the [n_cols, end-start] column matrix for a row range by
    visiting only the covering blocks (on-demand opening path)."""
    tau = blocks[0].tau if blocks else 0
    out = np.zeros((3 + 7 * tau, end - start), dtype=np.uint64)
    row = 0
    for b in blocks:
        ln = b.n_steps
        lo, hi = row, row + ln
        row = hi
        if hi <= start:
            continue
        if lo >= end:
            break
        m = block_column_matrix(b)
        s = max(start, lo)
        e = min(end, hi)
        out[:, s - start : e - start] = m[:, s - lo : e - lo]
    return out
