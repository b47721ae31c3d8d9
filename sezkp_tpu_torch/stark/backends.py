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
from .v0 import StarkIOP
from .v1 import proof as proof_mod
from .v1.prover import prove_v1
from .v1.verify import verify_v1

__all__ = ["FoldAgg", "FoldBackend", "StarkIOP", "StarkV1"]


class StarkV1:
    @staticmethod
    def prove(
        blocks: Sequence[BlockSummary], manifest_root: bytes, device=None, **options
    ) -> ProofArtifact:
        """`options` are prove_v1's keyword arguments: the route
        (`device_cols_min`), the device route's memory policy
        (`cv_budget_bytes`, `release_planes_bytes`, `compose_scan_min_log2`),
        the host-columns route's thresholds, and `timings`."""
        proof = prove_v1(blocks, manifest_root, device, **options)
        return ProofArtifact(
            backend=BackendKind.STARK,
            manifest_root=manifest_root,
            proof_bytes=proof_mod.encode_proof(proof),
            meta={"proto": "stark-v1", "domain_n": proof.domain_n, "tau": proof.tau},
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
