"""STARK v0 scaffold backend: streaming row-stream commitment + transcript proof.

Re-design of the reference v0 path (crates/sezkp-stark/src/{commit,witness,
air,verify}.rs). The per-step Rust loops become single numpy constructions:
the fixed-width row stream ``[input_mv u8, per tape (mv+1 u8, wflag u8)]``
(witness.rs:30-60) is one concatenation over the columnar movement logs, and
the write-in-window AIR check (air.rs:44-80) is a masked cumsum reduction.

Proof bytes are bit-exact with the reference: two 32-byte transcript
challenges (lib.rs:69-95).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.artifact import BackendKind, ProofArtifact
from ..core.types import BlockSummary
from ..crypto.transcript import Blake3Transcript

__all__ = ["StarkIOP", "encode_rows", "check_block_invariants", "commit_blocks_v0"]

CHUNK_ROWS = 4096


def row_size(tau: int) -> int:
    return 1 + 2 * tau


def encode_rows(blocks: Sequence[BlockSummary]) -> np.ndarray:
    """Fixed-width row encoding of all steps, uint8 [n_rows, 1 + 2*tau]."""
    if not blocks:
        return np.zeros((0, 1), dtype=np.uint8)
    tau = blocks[0].tau
    mats: List[np.ndarray] = []
    for b in blocks:
        ml = b.movement_log
        n = ml.n_steps
        rows = np.empty((n, row_size(tau)), dtype=np.uint8)
        rows[:, 0] = ml.input_mv.astype(np.uint8)  # i8 cast wraps like Rust `as u8`
        rows[:, 1::2] = (ml.tape_mv.astype(np.int16) + 1).astype(np.uint8)
        rows[:, 2::2] = ml.write_flag.astype(np.uint8)
        mats.append(rows)
    return np.concatenate(mats, axis=0)


def check_block_invariants(b: BlockSummary) -> None:
    """Write-in-window check; heads start at left + off_in (air.rs:44-80)."""
    left = b.windows[:, 0]
    right = b.windows[:, 1]
    start = left + b.head_in_offsets.astype(np.int64)
    ml = b.movement_log
    if ml.n_steps == 0:
        return
    heads = start[None, :] + np.cumsum(ml.tape_mv.astype(np.int64), axis=0)
    bad = ml.write_flag & ((heads < left[None, :]) | (heads > right[None, :]))
    if bad.any():
        i, r = np.unravel_index(int(np.argmax(bad)), bad.shape)
        raise ValueError(
            f"write outside window on tape {r}: pos={heads[i, r]}, "
            f"window=[{left[r]},{right[r]}]"
        )


def commit_blocks_v0(blocks: Sequence[BlockSummary]):
    """Streaming transcript commitment over the row stream (commit.rs:47-90).

    Returns (root32, n_rows, tau)."""
    if not blocks:
        tr = Blake3Transcript("sezkp-stark/v0/row-stream/empty")
        return tr.challenge_bytes("root", 32), 0, 0

    for k, b in enumerate(blocks):
        try:
            check_block_invariants(b)
        except ValueError as e:
            raise ValueError(
                f"ARE validation failed for block #{k} (k={b.block_id}): "
                f"invariant violation: {e}"
            ) from e
    tau = blocks[0].tau
    for k, b in enumerate(blocks[1:], 1):
        if b.tau != tau:
            raise ValueError(
                f"tau mismatch at block #{k} (k={b.block_id}): {b.tau} vs {tau}"
            )

    tr = Blake3Transcript("sezkp-stark/v0/row-stream")
    tr.absorb_u64("tau", tau)

    rows = encode_rows(blocks)
    n_rows = rows.shape[0]
    stream = rows.reshape(-1).tobytes()
    rl = row_size(tau)
    chunk_bytes = CHUNK_ROWS * rl
    for off in range(0, len(stream), chunk_bytes):
        tr.absorb("rows", stream[off : off + chunk_bytes])

    return tr.challenge_bytes("root", 32), n_rows, tau


def _proof_bytes(manifest_root: bytes, root: bytes, n_rows: int, tau: int) -> bytes:
    tr = Blake3Transcript("sezkp-stark-v0")
    tr.absorb("manifest_root", manifest_root)
    tr.absorb("commit_root", root)
    tr.absorb_u64("n_rows", n_rows)
    tr.absorb_u64("tau", tau)
    return tr.challenge_bytes("alpha", 32) + tr.challenge_bytes("beta", 32)


class StarkIOP:
    """v0 marker backend (reference: crates/sezkp-stark/src/lib.rs:65-112)."""

    @staticmethod
    def prove(blocks: Sequence[BlockSummary], manifest_root: bytes) -> ProofArtifact:
        root, n_rows, tau = commit_blocks_v0(blocks)
        proof = _proof_bytes(manifest_root, root, n_rows, tau)
        return ProofArtifact(
            backend=BackendKind.STARK,
            manifest_root=manifest_root,
            proof_bytes=proof,
            meta={"proto": "stark-v0", "n_rows": n_rows, "tau": tau},
        )

    @staticmethod
    def verify(
        artifact: ProofArtifact, blocks: Sequence[BlockSummary], manifest_root: bytes
    ) -> None:
        if artifact.backend != BackendKind.STARK:
            raise ValueError("backend kind mismatch: expected STARK")
        if artifact.manifest_root != manifest_root:
            raise ValueError("manifest root mismatch")
        root, n_rows, tau = commit_blocks_v0(blocks)
        expected = _proof_bytes(manifest_root, root, n_rows, tau)
        if expected != artifact.proof_bytes:
            raise ValueError("stark-v0 challenge mismatch")
