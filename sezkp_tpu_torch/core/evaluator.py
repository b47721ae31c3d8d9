"""One-shot bottom-up evaluator (reference: crates/sezkp-core/src/evaluator.rs).

Replays leaves, then combines adjacent intervals with doubling spans up to
Sigma([1, T]), enforcing the exact-replay interface check before each combine.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .combiner import ConstantCombiner
from .replay import ExactReplayer
from .types import BlockSummary, FiniteState

__all__ = ["Evaluator"]


class Evaluator:
    def __init__(
        self,
        replayer: ExactReplayer | None = None,
        combiner: ConstantCombiner | None = None,
    ):
        self.replayer = replayer or ExactReplayer()
        self.combiner = combiner or ConstantCombiner()

    def evaluate_root(self, blocks: Sequence[BlockSummary]) -> FiniteState:
        n = len(blocks)
        if n == 0:
            return FiniteState()

        states: Dict[Tuple[int, int], FiniteState] = {}
        for k in range(1, n + 1):
            states[(k, k)] = self.replayer.replay_block(blocks[k - 1])

        span = 1
        while span < n:
            start = 1
            while start <= n:
                mid = start + span - 1
                if mid >= n:
                    break
                end = min(start + 2 * span - 1, n)
                left = states[(start, mid)]
                right = states[(mid + 1, end)]
                if not self.replayer.interface_ok(left, right):
                    raise ValueError(
                        f"interface mismatch at [{start},{mid}] + [{mid + 1},{end}] "
                        "(exact replay check failed)"
                    )
                states[(start, end)] = self.combiner.combine(left, right)
                start += 2 * span
            span *= 2

        return states[(1, n)]
