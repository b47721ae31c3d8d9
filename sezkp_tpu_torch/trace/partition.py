"""Partition a trace into BlockSummary sigma_k blocks, vectorized.

Semantics match crates/sezkp-trace/src/partition.rs:43-150 exactly:
per-block relative heads start at 0; windows are the min/max of *post-move*
positions including the initial 0; entry offset = -left, exit = cur - left;
the input head is tracked absolutely across the whole trace.

The reference's per-step Rust loop becomes cumulative sums / running extrema
over the columnar movement log.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.types import BlockSummary, MovementLog
from .format import TraceFile

__all__ = ["partition_trace"]


def partition_trace(tf: TraceFile, b: int) -> List[BlockSummary]:
    t = len(tf)
    if t == 0:
        return []
    if b <= 0:
        raise ValueError("partition_trace: block size b must be > 0")

    tau = tf.tau
    ml = tf.steps

    # Global input-head prefix positions (after each step).
    in_prefix = np.concatenate(
        [[0], np.cumsum(ml.input_mv.astype(np.int64))]
    )  # [t+1]

    out: List[BlockSummary] = []
    k = 1
    for lo in range(0, t, b):
        hi = min(lo + b, t)
        n = hi - lo

        mv = ml.tape_mv[lo:hi].astype(np.int64)  # [n, tau]
        heads = np.cumsum(mv, axis=0)  # post-move positions, relative
        # windows include the entry position 0
        min_pos = np.minimum(heads.min(axis=0), 0)
        max_pos = np.maximum(heads.max(axis=0), 0)
        cur = heads[-1]

        off_in = -min_pos
        off_out = cur - min_pos

        # adjacent read-only views into the trace's contiguous log, not
        # copies of T rows: the blocks share the trace's memory
        block_ml = MovementLog(
            input_mv=ml.input_mv[lo:hi],
            tape_mv=ml.tape_mv[lo:hi],
            write_flag=ml.write_flag[lo:hi],
            write_sym=ml.write_sym[lo:hi],
        )

        out.append(
            BlockSummary(
                version=1,
                block_id=k,
                step_lo=lo + 1,
                step_hi=hi,
                ctrl_in=0,
                ctrl_out=0,
                in_head_in=int(in_prefix[lo]),
                in_head_out=int(in_prefix[hi]),
                windows=np.stack([min_pos, max_pos], axis=1).astype(np.int64),
                head_in_offsets=off_in.astype(np.uint32),
                head_out_offsets=off_out.astype(np.uint32),
                movement_log=block_ml,
                pre_tags=[b"\x00" * 16] * tau,
                post_tags=[b"\x00" * 16] * tau,
            )
        )
        k += 1

    return out
