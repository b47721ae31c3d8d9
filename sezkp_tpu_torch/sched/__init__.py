"""Height-compressed scheduler: pointerless DFS over half-open spans.

Re-implementation of crates/sezkp-scheduler/src/lib.rs (dfs, max_live_frames,
balanced_tree) plus the inclusive-interval helpers from hct.rs and the event
iterator from dfs.rs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Tuple, Union

__all__ = [
    "Interval",
    "balanced_tree",
    "dfs",
    "max_live_frames",
    "ceil_log2",
    "children",
    "depth_bound",
    "DescendLeaf",
    "Combine",
    "Done",
    "dfs_events",
]


@dataclass(frozen=True)
class Interval:
    """Half-open interval [lo, hi)."""

    lo: int
    hi: int

    def __len__(self) -> int:
        return max(0, self.hi - self.lo)

    def is_leaf(self) -> bool:
        return len(self) <= 1

    def split_mid(self) -> Tuple["Interval", "Interval"]:
        n = len(self)
        if n <= 1:
            return self, self
        mid = self.lo + n // 2
        return Interval(self.lo, mid), Interval(mid, self.hi)


def balanced_tree(t: int) -> Interval:
    return Interval(0, t)


def dfs(
    t: int,
    on_leaf: Callable[[Interval], None],
    on_merge: Callable[[Interval], None],
) -> None:
    """Post-order DFS with balanced splits; O(log t) frames, no allocations."""
    if t == 0:
        return
    stack = [[balanced_tree(t), 0]]  # [span, state]
    while stack:
        span, state = stack[-1]
        if span.is_leaf():
            stack.pop()
            on_leaf(span)
            while stack:
                parent = stack[-1]
                if parent[1] == 0:
                    parent[1] = 1
                    _, r = parent[0].split_mid()
                    stack.append([r, 0])
                    break
                stack.pop()
                on_merge(parent[0])
            continue
        if state == 0:
            l, _ = span.split_mid()
            stack.append([l, 0])


def max_live_frames(t: int) -> int:
    if t == 0:
        return 0
    depth = 0
    stack = [[balanced_tree(t), 0]]
    while stack:
        depth = max(depth, len(stack))
        span, state = stack[-1]
        if span.is_leaf():
            stack.pop()
            while stack:
                depth = max(depth, len(stack))
                parent = stack[-1]
                if parent[1] == 0:
                    parent[1] = 1
                    _, r = parent[0].split_mid()
                    stack.append([r, 0])
                    break
                stack.pop()
            continue
        if state == 0:
            l, _ = span.split_mid()
            stack.append([l, 0])
            depth = max(depth, len(stack))
    return depth


def ceil_log2(x: int) -> int:
    if x <= 1:
        return 0
    return (x - 1).bit_length()


# ----------------------- inclusive-interval helpers (hct.rs) -----------------


def children(i: int, j: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Inclusive [i,j] -> ([i,m], [m+1,j]) with m = midpoint (hct.rs:36-44)."""
    m = i + (j - i) // 2
    return (i, m), (m + 1, j)


def depth_bound(t: int) -> int:
    return ceil_log2(t) + 1


# --------------------------- event iterator (dfs.rs) ------------------------


@dataclass(frozen=True)
class DescendLeaf:
    k: int  # 1-based leaf index


@dataclass(frozen=True)
class Combine:
    left: Tuple[int, int]
    right: Tuple[int, int]


@dataclass(frozen=True)
class Done:
    pass


def dfs_events(t: int) -> Iterator[Union[DescendLeaf, Combine, Done]]:
    """Events over the inclusive interval [1, t]: leaves in order, post-order
    combines, then Done (reference: scheduler/dfs.rs:33-142)."""

    def rec(i: int, j: int):
        if i == j:
            yield DescendLeaf(i)
            return
        (li, lj), (ri, rj) = children(i, j)
        yield from rec(li, lj)
        yield from rec(ri, rj)
        yield Combine((li, lj), (ri, rj))

    if t > 0:
        yield from rec(1, t)
    yield Done()
