"""Algebraic Replay Engine (ARE), vectorized.

Re-design of the reference's per-step scan (crates/sezkp-core/src/replay.rs:
66-197) as numpy reductions over the columnar movement log: head evolution is
a cumulative sum over moves, and the write-in-window safety check is a masked
min/max reduction. Declared endpoints remain authoritative interface data
(replay.rs:7-12).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import BlockSummary, FiniteState

__all__ = ["ReplayConfig", "Replay", "ExactReplayer", "ReplayError"]


class ReplayError(ValueError):
    pass


@dataclass
class ReplayConfig:
    check_writes: bool = False


class Replay:
    def __init__(self, cfg: ReplayConfig | None = None):
        self.cfg = cfg or ReplayConfig()

    @staticmethod
    def interface_ok(a: FiniteState, b: FiniteState) -> bool:
        """Minimal composition condition (replay.rs:51-53): ctrl chaining and
        input-head continuity. Work-head continuity is deliberately not
        required here."""
        return a.ctrl_out == b.ctrl_in and a.in_head_out == b.in_head_in

    def replay_block(self, sigma: BlockSummary) -> FiniteState:
        tau = sigma.tau
        bid = sigma.block_id

        if sigma.head_in_offsets.shape[0] != tau:
            raise ReplayError(
                f"block {bid}: head_in_offsets length "
                f"{sigma.head_in_offsets.shape[0]} != windows length {tau}"
            )
        if sigma.head_out_offsets.shape[0] != tau:
            raise ReplayError(
                f"block {bid}: head_out_offsets length "
                f"{sigma.head_out_offsets.shape[0]} != windows length {tau}"
            )

        left = sigma.windows[:, 0]
        right = sigma.windows[:, 1]
        if np.any(right < left):
            r = int(np.argmax(right < left))
            raise ReplayError(
                f"block {bid}: invalid window on tape {r}: right < left "
                f"({right[r]} < {left[r]})"
            )

        win_len = right - left  # inclusive span minus one
        off_in = sigma.head_in_offsets.astype(np.int64)
        off_out = sigma.head_out_offsets.astype(np.int64)
        if np.any(off_in > win_len):
            r = int(np.argmax(off_in > win_len))
            raise ReplayError(
                f"block {bid}: entry offset {off_in[r]} out of window range "
                f"[0, {win_len[r]}] on tape {r}"
            )

        ml = sigma.movement_log
        if np.any(np.abs(ml.input_mv.astype(np.int64)) > 1):
            i = int(np.argmax(np.abs(ml.input_mv.astype(np.int64)) > 1))
            raise ReplayError(
                f"block {bid}: input head move must be in {{-1,0,1}}, got "
                f"{ml.input_mv[i]} at step {i}"
            )
        if ml.tape_mv.shape[1] != tau:
            raise ReplayError(
                f"block {bid}: steps have {ml.tape_mv.shape[1]} tape ops, expected {tau}"
            )
        if np.any(np.abs(ml.tape_mv.astype(np.int64)) > 1):
            flat = np.abs(ml.tape_mv.astype(np.int64)) > 1
            i, r = np.unravel_index(int(np.argmax(flat)), flat.shape)
            raise ReplayError(
                f"block {bid}: tape {r} head move must be in {{-1,0,1}}, got "
                f"{ml.tape_mv[i, r]} at step {i}"
            )

        work_in = left + off_in

        if self.cfg.check_writes and ml.n_steps > 0:
            # head position after each step: work_in + cumsum(mv) per tape.
            heads = work_in[None, :] + np.cumsum(
                ml.tape_mv.astype(np.int64), axis=0
            )  # [n, tau]
            w = ml.write_flag
            bad = w & ((heads < left[None, :]) | (heads > right[None, :]))
            if bad.any():
                i, r = np.unravel_index(int(np.argmax(bad)), bad.shape)
                raise ReplayError(
                    f"block {bid}: write outside window on tape {r} at step {i}: "
                    f"pos={heads[i, r]}, window=[{left[r]},{right[r]}]"
                )

        if np.any(off_out > win_len):
            r = int(np.argmax(off_out > win_len))
            raise ReplayError(
                f"block {bid}: exit offset {off_out[r]} out of window range "
                f"[0, {win_len[r]}] on tape {r}"
            )
        work_out = left + off_out

        return FiniteState(
            ctrl_in=sigma.ctrl_in,
            ctrl_out=sigma.ctrl_out,
            in_head_in=sigma.in_head_in,
            in_head_out=sigma.in_head_out,
            work_head_in=np.asarray(work_in, dtype=np.int64),
            work_head_out=np.asarray(work_out, dtype=np.int64),
        )


class ExactReplayer:
    """Infallible wrapper (panics -> raises) used by the evaluator/tests."""

    def __init__(self, cfg: ReplayConfig | None = None):
        self.inner = Replay(cfg)

    def interface_ok(self, a: FiniteState, b: FiniteState) -> bool:
        return self.inner.interface_ok(a, b)

    def replay_block(self, sigma: BlockSummary) -> FiniteState:
        return self.inner.replay_block(sigma)
