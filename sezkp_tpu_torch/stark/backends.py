"""STARK backend classes implementing the ProvingBackend surface.

Mirrors crates/sezkp-stark/src/lib.rs:126-191: `StarkV1` serializes ProofV1
with bincode into the artifact bytes; metadata is JSON. Counterpart of
sezkp_tpu/stark/backends.py with an explicit device: `device=None` proves on
the CUDA card and raises without one; the CPU runs only for device="cpu".
Verification is host code. The fold backend (fold/backend.py) is exported
here too, so that every proving backend is found in one place.
"""

from __future__ import annotations

from typing import Sequence

from ..core.artifact import BackendKind, ProofArtifact
from ..core.types import BlockSummary
from ..fold.backend import FoldAgg, FoldBackend
from ..utils import tracing
from .v0 import StarkIOP
from .v1 import proof as proof_mod
from .v1.prover import prove_v1
from .v1.verify import verify_v1

__all__ = ["FoldAgg", "FoldBackend", "StarkIOP", "StarkV1"]


def _encode(proof, timings) -> bytes:
    """The proof's bincode bytes, timed as the prove's last stage (host
    code: it queues no device work, so its edge needs no sync)."""
    stages = tracing.Stages(timings, None)
    out = proof_mod.encode_proof(proof)
    stages.mark("encode", tracing.HOST)
    return out


class StarkV1:
    @staticmethod
    def prove(
        blocks: Sequence[BlockSummary], manifest_root: bytes, device=None, **options
    ) -> ProofArtifact:
        """`options` are prove_v1's keyword arguments: the route
        (`device_cols_min`), the device route's memory policy
        (`cv_budget_bytes`, `release_planes_bytes`, `compose_scan_min_log2`),
        the host-columns route's thresholds, the LDE domain from which FRI
        takes its chunked tops-only mode (`fri_chunked_min_log2`), and
        `timings`, which also receives `encode`, the seconds of the bincode
        encoding, after prove_v1's stages."""
        timings = options.get("timings")
        with tracing.proving(timings):
            proof = prove_v1(blocks, manifest_root, device, **options)
            proof_bytes = _encode(proof, timings)
        return ProofArtifact(
            backend=BackendKind.STARK,
            manifest_root=manifest_root,
            proof_bytes=proof_bytes,
            meta={"proto": "stark-v1", "domain_n": proof.domain_n, "tau": proof.tau},
        )

    @staticmethod
    def prove_streaming(
        blocks: Sequence[BlockSummary], manifest_root: bytes, device=None, **options
    ) -> ProofArtifact:
        """The same proof bytes from the O(chunk)-memory column commitments
        (prove_v1 with streaming=True); `options` as for `prove`
        (`fri_chunked_min_log2` among them)."""
        timings = options.get("timings")
        with tracing.proving(timings):
            proof = prove_v1(blocks, manifest_root, device, streaming=True, **options)
            proof_bytes = _encode(proof, timings)
        return ProofArtifact(
            backend=BackendKind.STARK,
            manifest_root=manifest_root,
            proof_bytes=proof_bytes,
            meta={
                "proto": "stark-v1",
                "mode": "streaming",
                "domain_n": proof.domain_n,
                "tau": proof.tau,
            },
        )

    @staticmethod
    def verify(
        artifact: ProofArtifact, blocks: Sequence[BlockSummary], manifest_root: bytes
    ) -> None:
        if artifact.backend != BackendKind.STARK:
            raise ValueError("backend kind mismatch: expected STARK")
        if artifact.manifest_root != manifest_root:
            raise ValueError("manifest root mismatch")
        proof = proof_mod.decode_proof(artifact.proof_bytes)
        verify_v1(proof, blocks)
