"""Event-driven evaluation oracle (reference: crates/sezkp-scheduler/src/evaluator.rs).

Mirrors the core Evaluator but is driven by the DFS event stream
(DescendLeaf / Combine / Done) instead of an internal doubling schedule.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ..core.combiner import ConstantCombiner
from ..core.replay import ExactReplayer
from ..core.types import BlockSummary, FiniteState
from . import Combine, DescendLeaf, Done, dfs_events

__all__ = ["DrivingEvaluator"]


class DrivingEvaluator:
    def __init__(self):
        self.replayer = ExactReplayer()
        self.combiner = ConstantCombiner()

    def evaluate_root(self, blocks: Sequence[BlockSummary]) -> FiniteState:
        n = len(blocks)
        if n == 0:
            return FiniteState()
        states: Dict[Tuple[int, int], FiniteState] = {}
        for ev in dfs_events(n):
            if isinstance(ev, DescendLeaf):
                states[(ev.k, ev.k)] = self.replayer.replay_block(blocks[ev.k - 1])
            elif isinstance(ev, Combine):
                left = states.pop(ev.left)
                right = states.pop(ev.right)
                if not self.replayer.interface_ok(left, right):
                    raise ValueError(
                        f"interface mismatch at {ev.left} + {ev.right}"
                    )
                states[(ev.left[0], ev.right[1])] = self.combiner.combine(left, right)
            elif isinstance(ev, Done):
                break
        return states[(1, n)]
