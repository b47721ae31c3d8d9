"""Streaming prover facade (reference: crates/sezkp-core/src/prover.rs).

Validates blocks with ARE + pairwise interface checks, then delegates to a
backend. The streaming variants keep only the previous boundary FiniteState
alive and push blocks into a backend stream.

Backends are classes exposing:
  prove(blocks, manifest_root, **options) -> ProofArtifact
    (options are the backend's own keywords, e.g. device, device_hash_min)
  verify(artifact, blocks, manifest_root) -> None (raises on failure)
and optionally the streaming API:
  begin_stream(manifest_root) -> state
  ingest_block(state, block) -> None
  finish_stream(state) -> ProofArtifact
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from .artifact import ProofArtifact
from .replay import Replay, ReplayConfig
from .types import BlockSummary, FiniteState

__all__ = ["StreamingProver"]


class StreamingProver:
    def __init__(self, backend, replay_cfg: ReplayConfig | None = None):
        self.backend = backend
        self.replay = Replay(replay_cfg or ReplayConfig(check_writes=True))

    # ------------------------------ batch ----------------------------------

    def prove(
        self, blocks: Sequence[BlockSummary], manifest_root: bytes, **options
    ) -> ProofArtifact:
        """`options` go to the backend's `prove` as keywords (the device and
        the device-hash threshold of StarkV1 and FoldBackend)."""
        self.validate_blocks(blocks)
        return self.backend.prove(blocks, manifest_root, **options)

    def verify(
        self, artifact: ProofArtifact, blocks: Sequence[BlockSummary], manifest_root: bytes
    ) -> None:
        self.validate_blocks(blocks)
        self.backend.verify(artifact, blocks, manifest_root)

    # ---------------------------- streaming ---------------------------------

    def prove_stream_iter(
        self, blocks_iter: Iterable[BlockSummary], manifest_root: bytes
    ) -> ProofArtifact:
        state = self.backend.begin_stream(manifest_root)
        prev: Optional[FiniteState] = None
        for idx, block in enumerate(blocks_iter):
            fs = self._replay_checked(block, idx)
            self._check_interface(prev, fs, idx, block)
            prev = fs
            self.backend.ingest_block(state, block)
        return self.backend.finish_stream(state)

    def verify_stream_iter(
        self,
        artifact: ProofArtifact,
        blocks_iter: Iterable[BlockSummary],
        manifest_root: bytes,
    ) -> None:
        prev: Optional[FiniteState] = None
        for idx, block in enumerate(blocks_iter):
            fs = self._replay_checked(block, idx)
            self._check_interface(prev, fs, idx, block)
            prev = fs
        self.backend.verify(artifact, [], manifest_root)

    # ----------------------------- helpers ----------------------------------

    def _replay_checked(self, block: BlockSummary, idx: int) -> FiniteState:
        try:
            return self.replay.replay_block(block)
        except Exception as e:
            raise ValueError(
                f"ARE validation failed at block index {idx} "
                f"(block_id={block.block_id}): {e}"
            ) from e

    def _check_interface(
        self, prev: Optional[FiniteState], fs: FiniteState, idx: int, block: BlockSummary
    ) -> None:
        if prev is not None and not self.replay.interface_ok(prev, fs):
            raise ValueError(
                f"interface mismatch at boundary {max(idx - 1, 0)}->{idx} "
                f"(block_id={block.block_id}): "
                "(ctrl_out,in_head_out) != (ctrl_in,in_head_in)"
            )

    def validate_blocks(self, blocks: Sequence[BlockSummary]) -> None:
        if not blocks:
            return
        fstates = [self._replay_checked(b, i) for i, b in enumerate(blocks)]
        for i in range(len(fstates) - 1):
            if not self.replay.interface_ok(fstates[i], fstates[i + 1]):
                raise ValueError(
                    f"interface mismatch at boundary {i}->{i + 1}: "
                    "(ctrl_out,in_head_out) != (ctrl_in,in_head_in)"
                )
