"""Constant-size finite-state combiner (reference: crates/sezkp-core/src/combiner.rs)."""

from __future__ import annotations

import numpy as np

from .types import FiniteState

__all__ = ["ConstantCombiner"]


class ConstantCombiner:
    """Entry from left, exit from right, flags XOR, tag from right.

    `interface_ok` additionally requires per-tape work-head equality
    (combiner.rs:115-128) — stricter than Replay.interface_ok."""

    @staticmethod
    def interface_ok(left: FiniteState, right: FiniteState) -> bool:
        return (
            left.ctrl_out == right.ctrl_in
            and left.in_head_out == right.in_head_in
            and np.array_equal(left.work_head_out, right.work_head_in)
        )

    @staticmethod
    def combine(left: FiniteState, right: FiniteState) -> FiniteState:
        tau = max(left.work_head_in.shape[0], right.work_head_out.shape[0])
        whi = np.zeros(tau, dtype=np.int64)
        whi[: left.work_head_in.shape[0]] = left.work_head_in
        who = np.zeros(tau, dtype=np.int64)
        who[: right.work_head_out.shape[0]] = right.work_head_out
        return FiniteState(
            ctrl_in=left.ctrl_in,
            ctrl_out=right.ctrl_out,
            in_head_in=left.in_head_in,
            in_head_out=right.in_head_out,
            work_head_in=whi,
            work_head_out=who,
            flags=left.flags ^ right.flags,
            tag=right.tag,
        )

    def combine_checked(self, left: FiniteState, right: FiniteState) -> FiniteState:
        if not self.interface_ok(left, right):
            raise ValueError(
                "invalid interface: left.out does not match right.in "
                "(control/head continuity)"
            )
        return self.combine(left, right)
