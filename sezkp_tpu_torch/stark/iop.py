"""Mock IOP-style commitment over block interfaces (reference: sezkp-stark/src/iop.rs).

Deterministic Fiat-Shamir over per-block interface tuples; the "proof" is
three 32-byte challenges. Kept for plumbing/serialization exercises.
"""

from __future__ import annotations

from typing import Sequence

from ..core.types import BlockSummary
from ..crypto.transcript import Blake3Transcript

__all__ = ["commit_block_fiat_shamir", "zigzag_i64"]


def zigzag_i64(x: int) -> int:
    """ZigZag encode i64 -> u64: 0->0, -1->1, 1->2, ... (iop.rs:31-36)."""
    return ((x << 1) ^ (x >> 63)) & 0xFFFFFFFFFFFFFFFF


def _absorb_block_iface(tr: Blake3Transcript, b: BlockSummary) -> None:
    tr.absorb_u64("block_id", b.block_id)
    tr.absorb_u64("step_lo", b.step_lo)
    tr.absorb_u64("step_hi", b.step_hi)
    tr.absorb_u64("ctrl_in", b.ctrl_in)
    tr.absorb_u64("ctrl_out", b.ctrl_out)
    tr.absorb_u64("steps_len", b.movement_log.n_steps)
    tr.absorb_u64("input_drift", zigzag_i64(b.in_head_out - b.in_head_in))
    tr.absorb_u64("tau", b.tau)
    for r in range(b.tau):
        in_abs = int(b.windows[r, 0]) + int(b.head_in_offsets[r])
        out_abs = int(b.windows[r, 0]) + int(b.head_out_offsets[r])
        tr.absorb_u64("tape_idx", r)
        tr.absorb_u64("tape_drift", zigzag_i64(out_abs - in_abs))


def commit_block_fiat_shamir(
    tr: Blake3Transcript, blocks: Sequence[BlockSummary]
) -> bytes:
    tr.absorb_u64("n_blocks", len(blocks))
    for b in blocks:
        _absorb_block_iface(tr, b)
    return (
        tr.challenge_bytes("alpha", 32)
        + tr.challenge_bytes("beta", 32)
        + tr.challenge_bytes("gamma", 32)
    )
