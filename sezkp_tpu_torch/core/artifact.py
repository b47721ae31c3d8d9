"""Proof artifact envelope (reference: crates/sezkp-core/src/artifact.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["BackendKind", "ProofArtifact"]


class BackendKind:
    """Backend tags; serialized lowercase, unknown values decode to UNKNOWN
    (reference: artifact.rs:31-48 with serde(rename_all = "lowercase"))."""

    STARK = "stark"
    FOLD = "fold"
    UNKNOWN = "unknown"

    _KNOWN = ("stark", "fold")

    @staticmethod
    def decode(s: str) -> str:
        return s if s in BackendKind._KNOWN else BackendKind.UNKNOWN


@dataclass
class ProofArtifact:
    backend: str
    manifest_root: bytes  # 32 bytes
    proof_bytes: bytes
    meta: Any = field(default=None)

    def to_obj(self):
        return {
            "backend": self.backend,
            "manifest_root": list(self.manifest_root),
            "proof_bytes": list(self.proof_bytes),
            "meta": _meta_sorted(self.meta),
        }

    @staticmethod
    def from_obj(o) -> "ProofArtifact":
        return ProofArtifact(
            backend=BackendKind.decode(o["backend"]) if isinstance(o["backend"], str) else BackendKind.UNKNOWN,
            manifest_root=bytes(o["manifest_root"]),
            proof_bytes=bytes(o["proof_bytes"]),
            meta=o.get("meta"),
        )


def _meta_sorted(meta: Any) -> Any:
    """serde_json::Value objects are BTreeMaps -> keys serialize sorted."""
    if isinstance(meta, dict):
        return {k: _meta_sorted(meta[k]) for k in sorted(meta)}
    if isinstance(meta, list):
        return [_meta_sorted(x) for x in meta]
    return meta
