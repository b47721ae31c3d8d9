"""Fold drivers: batch (Balanced / MinRam), streaming, and CBOR-seq sinks.

Reference: crates/sezkp-fold/src/driver.rs. The streaming driver reproduces
the balanced midpoint tree incrementally via the collapse rule
`(l.lo + r.hi) / 2 == l.hi` with an O(log T) stack of subtrees.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Sequence, Tuple

from .. import sched
from ..core.types import BlockSummary
from ..stark.v1.columns import interface_boundary_digest
from ..utils import cbor
from .api import Commitment, DriverOptions, FoldMode, PiCommitment, commit_pi
from .are import InterfaceWitness, Pi
from .gadgets import (
    CryptoFold,
    CryptoFoldProof,
    CryptoLeaf,
    CryptoLeafProof,
    CryptoWrap,
    CryptoWrapProof,
)

STREAM_MAGIC = "sezkp-fold-seq"
STREAM_VERSION = 1


@dataclass
class FoldProofBundle:
    n_blocks: int
    tree_span: Tuple[int, int]
    leaves: List[Tuple[Commitment, Pi, CryptoLeafProof]] = field(default_factory=list)
    folds: List[
        Tuple[
            Tuple[Commitment, Pi],
            Tuple[Commitment, Pi],
            Tuple[Commitment, Pi],
            CryptoFoldProof,
        ]
    ] = field(default_factory=list)
    wraps: List[Tuple[Tuple[Commitment, Pi], CryptoWrapProof]] = field(
        default_factory=list
    )

    # ---- serde (serde_cbor shape, used inside the artifact envelope) -------

    def to_obj(self):
        def cp(c: Commitment, p: Pi):
            return [c.to_obj(), p.to_obj()]

        return {
            "n_blocks": self.n_blocks,
            "tree_span": list(self.tree_span),
            "leaves": [[c.to_obj(), p.to_obj(), pr.to_obj()] for c, p, pr in self.leaves],
            "folds": [
                [cp(*par), cp(*l), cp(*r), pf.to_obj()] for par, l, r, pf in self.folds
            ],
            "wraps": [[cp(*root), wp.to_obj()] for root, wp in self.wraps],
        }

    @staticmethod
    def from_obj(o) -> "FoldProofBundle":
        def cp(x) -> Tuple[Commitment, Pi]:
            return Commitment.from_obj(x[0]), Pi.from_obj(x[1])

        b = FoldProofBundle(n_blocks=o["n_blocks"], tree_span=tuple(o["tree_span"]))
        b.leaves = [
            (Commitment.from_obj(c), Pi.from_obj(p), CryptoLeafProof.from_obj(pr))
            for c, p, pr in o["leaves"]
        ]
        b.folds = [
            (cp(par), cp(l), cp(r), CryptoFoldProof.from_obj(pf))
            for par, l, r, pf in o["folds"]
        ]
        b.wraps = [(cp(root), CryptoWrapProof.from_obj(wp)) for root, wp in o["wraps"]]
        return b


def _iface(left_pi: Pi, right_pi: Pi, left_blk: BlockSummary, right_blk: BlockSummary):
    return InterfaceWitness(
        left_ctrl_out=left_pi.ctrl_out,
        right_ctrl_in=right_pi.ctrl_in,
        boundary_writes_digest=interface_boundary_digest(left_blk, right_blk),
    )


def run_pipeline(
    blocks: Sequence[BlockSummary], opts: DriverOptions
) -> FoldProofBundle:
    """Batch driver: Balanced (endpoint ledger) or MinRam (recompute + LRU)."""
    t = len(blocks)
    if t == 0:
        return FoldProofBundle(0, (0, 0))

    root = sched.balanced_tree(t)
    out = FoldProofBundle(t, (root.lo, root.hi))

    def maybe_wrap(c_par: Commitment, pi_par: Pi):
        if opts.wrap_cadence and len(out.folds) % opts.wrap_cadence == 0:
            out.wraps.append(((c_par, pi_par), CryptoWrap.wrap((c_par, pi_par))))

    if opts.fold_mode == FoldMode.BALANCED:
        ledger: List[Optional[Tuple[Commitment, Pi]]] = [None] * t

        def on_leaf(span: sched.Interval):
            i = span.lo
            pi, c, pr = CryptoLeaf.prove_leaf(blocks[i])
            ledger[i] = (c, pi)
            out.leaves.append((c, pi, pr))

        def on_merge(span: sched.Interval):
            l, r = span.split_mid()
            ci, pi_i = ledger[l.lo]
            cj, pj = ledger[r.lo]
            iface = _iface(pi_i, pj, blocks[l.hi - 1], blocks[r.lo])
            c_par, pi_par, pf = CryptoFold.fold((ci, pi_i), (cj, pj), iface)
            out.folds.append(((c_par, pi_par), (ci, pi_i), (cj, pj), pf))
            maybe_wrap(c_par, pi_par)
            ledger[l.lo] = (c_par, pi_par)
            ledger[r.lo] = None

        sched.dfs(t, on_leaf, on_merge)
    else:  # MinRam
        cache: OrderedDict = OrderedDict()
        cap = opts.endpoint_cache

        def cache_put(key, v):
            if cap == 0:
                return
            if key not in cache and len(cache) == cap:
                cache.popitem(last=False)
            cache[key] = v
            cache.move_to_end(key)

        def build_endpoint(span: sched.Interval) -> Tuple[Commitment, Pi]:
            key = (span.lo, span.hi)
            if key in cache:
                cache.move_to_end(key)
                return cache[key]
            if span.is_leaf():
                i = span.lo
                pi, c, pr = CryptoLeaf.prove_leaf(blocks[i])
                out.leaves.append((c, pi, pr))
                cache_put(key, (c, pi))
                return c, pi
            l, r = span.split_mid()
            ci, pi_i = build_endpoint(l)
            cj, pj = build_endpoint(r)
            iface = _iface(pi_i, pj, blocks[l.hi - 1], blocks[r.lo])
            c_par, pi_par, pf = CryptoFold.fold((ci, pi_i), (cj, pj), iface)
            out.folds.append(((c_par, pi_par), (ci, pi_i), (cj, pj), pf))
            maybe_wrap(c_par, pi_par)
            cache_put(key, (c_par, pi_par))
            return c_par, pi_par

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * sched.ceil_log2(t) + 128))
        try:
            build_endpoint(root)
        finally:
            sys.setrecursionlimit(old)

    return out


# --------------------------- streaming wire format --------------------------


def header_obj(opts: DriverOptions):
    return {
        "magic": STREAM_MAGIC,
        "ver": STREAM_VERSION,
        "wrap_cadence": opts.wrap_cadence,
        "mode": opts.fold_mode,
        "reserved": 0,
    }


def footer_obj(n_blocks: int, root_c: Commitment, root_pi_cmt: PiCommitment):
    return {
        "n_blocks": n_blocks,
        "root_c": root_c.to_obj(),
        "root_pi_cmt": root_pi_cmt.to_obj(),
    }


class CborSeqSink:
    """Writes Header / Item* / Footer as back-to-back CBOR values."""

    def __init__(self, fh: BinaryIO):
        self.fh = fh

    def start(self, header) -> None:
        self.fh.write(cbor.dumps(header))

    def on_leaf(self, c: Commitment, pi_cmt: PiCommitment, proof: CryptoLeafProof):
        item = {"Leaf": {"c": c.to_obj(), "pi_cmt": pi_cmt.to_obj(), "proof": proof.to_obj()}}
        self.fh.write(cbor.dumps(item))

    def on_fold(self, parent, left, right, proof: CryptoFoldProof):
        def cp(x):
            return [x[0].to_obj(), x[1].to_obj()]

        item = {
            "Fold": {
                "parent": cp(parent),
                "left": cp(left),
                "right": cp(right),
                "proof": proof.to_obj(),
            }
        }
        self.fh.write(cbor.dumps(item))

    def on_wrap(self, root, proof: CryptoWrapProof):
        item = {"Wrap": {"root": [root[0].to_obj(), root[1].to_obj()], "proof": proof.to_obj()}}
        self.fh.write(cbor.dumps(item))

    def finish(self, footer) -> None:
        self.fh.write(cbor.dumps(footer))


@dataclass
class _Subtree:
    lo: int
    hi: int
    c: Commitment
    p: Pi
    first: BlockSummary
    last: BlockSummary


class StreamDriverSink:
    """Push-based streaming driver emitting to a sink; O(log T) live state.

    Collapse rule: merge the top two adjacent stack subtrees when the balanced
    midpoint of their union equals their boundary (driver.rs:641-644)."""

    def __init__(self, sink, opts: DriverOptions):
        self.sink = sink
        self.opts = opts
        self.next_idx = 0
        self.stack: List[_Subtree] = []
        self.leaves_seen = 0
        self.folds_emitted = 0
        sink.start(header_obj(opts))

    def push_block(self, block: BlockSummary) -> None:
        pi, c, pr = CryptoLeaf.prove_leaf(block)
        self.sink.on_leaf(c, commit_pi(pi), pr)
        self.leaves_seen += 1
        i = self.next_idx
        self.next_idx += 1
        self.stack.append(_Subtree(i, i + 1, c, pi, block, block))
        self._try_collapses()

    def _try_collapses(self) -> None:
        while len(self.stack) >= 2:
            l = self.stack[-2]
            r = self.stack[-1]
            if l.hi != r.lo:
                break
            if (l.lo + r.hi) // 2 != l.hi:
                break
            right = self.stack.pop()
            left = self.stack.pop()
            iface = _iface(left.p, right.p, left.last, right.first)
            c_par, p_par, pf = CryptoFold.fold(
                (left.c, left.p), (right.c, right.p), iface
            )
            self.sink.on_fold(
                (c_par, commit_pi(p_par)),
                (left.c, commit_pi(left.p)),
                (right.c, commit_pi(right.p)),
                pf,
            )
            self.folds_emitted += 1
            if self.opts.wrap_cadence and self.folds_emitted % self.opts.wrap_cadence == 0:
                w = CryptoWrap.wrap((c_par, p_par))
                self.sink.on_wrap((c_par, commit_pi(p_par)), w)
            self.stack.append(
                _Subtree(left.lo, right.hi, c_par, p_par, left.first, right.last)
            )

    def finish(self) -> Tuple[Commitment, Pi]:
        self._try_collapses()
        if self.stack:
            top = self.stack[-1]
            root_c, root_pi = top.c, top.p
        else:
            root_c, root_pi = Commitment(b"\x00" * 32, 0), Pi()
        self.sink.finish(footer_obj(self.leaves_seen, root_c, commit_pi(root_pi)))
        return root_c, root_pi


class BundleCollectorSink:
    """In-memory sink used by StreamDriver-to-bundle flows and tests."""

    def __init__(self):
        self.header = None
        self.items = []
        self.footer = None

    def start(self, header):
        self.header = header

    def on_leaf(self, c, pi_cmt, proof):
        self.items.append(("leaf", c, pi_cmt, proof))

    def on_fold(self, parent, left, right, proof):
        self.items.append(("fold", parent, left, right, proof))

    def on_wrap(self, root, proof):
        self.items.append(("wrap", root, proof))

    def finish(self, footer):
        self.footer = footer
