"""VM-agnostic trace envelope (reference: crates/sezkp-trace/src/format.rs).

Stored columnar (numpy) like MovementLog; wire codecs produce the serde shape
{version, tau, steps: [{input_mv, tapes: [{write, mv}]}], meta}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..core.types import MovementLog

__all__ = ["TraceFile"]


@dataclass
class TraceFile:
    version: int
    tau: int
    steps: MovementLog  # columnar [t] / [t, tau]
    meta: Optional[Any] = None

    def __len__(self) -> int:
        return self.steps.n_steps

    def to_obj(self) -> Dict[str, Any]:
        return {
            "version": int(self.version),
            "tau": int(self.tau),
            "steps": self.steps.to_steps(),
            "meta": self.meta,
        }

    @staticmethod
    def from_obj(o: Dict[str, Any]) -> "TraceFile":
        tau = o["tau"]
        return TraceFile(
            version=o["version"],
            tau=tau,
            steps=MovementLog.from_steps(o["steps"], tau),
            meta=o.get("meta"),
        )
