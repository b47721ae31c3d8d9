"""Canonical core types, stored in TPU-friendly columnar form.

The reference keeps movement logs as ``Vec<StepProjection>`` of per-tape ops
(reference: crates/sezkp-core/src/types.rs:96-151). For a TPU-native design we
store each block's movement log as dense numpy arrays so that replay, column
building, hashing, and NTT witness generation are all vectorized:

- ``input_mv``  : int8   [n]
- ``tape_mv``   : int8   [n, tau]
- ``write_flag``: bool   [n, tau]
- ``write_sym`` : uint16 [n, tau]   (0 where no write)

Wire codecs (JSON/CBOR/JSONL) convert to/from the serde shape of the Rust
structs so artifacts remain bit-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "Window",
    "MovementLog",
    "BlockSummary",
    "FiniteState",
    "Interval",
]


@dataclass
class MovementLog:
    """Columnar per-block movement log (length n, tau tapes)."""

    input_mv: np.ndarray  # int8 [n]
    tape_mv: np.ndarray  # int8 [n, tau]
    write_flag: np.ndarray  # bool [n, tau]
    write_sym: np.ndarray  # uint16 [n, tau]

    @property
    def n_steps(self) -> int:
        return int(self.input_mv.shape[0])

    @property
    def tau(self) -> int:
        return int(self.tape_mv.shape[1]) if self.tape_mv.ndim == 2 else 0

    @staticmethod
    def empty(tau: int) -> "MovementLog":
        return MovementLog(
            input_mv=np.zeros(0, dtype=np.int8),
            tape_mv=np.zeros((0, tau), dtype=np.int8),
            write_flag=np.zeros((0, tau), dtype=bool),
            write_sym=np.zeros((0, tau), dtype=np.uint16),
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MovementLog):
            return NotImplemented
        return (
            np.array_equal(self.input_mv, other.input_mv)
            and np.array_equal(self.tape_mv, other.tape_mv)
            and np.array_equal(self.write_flag, other.write_flag)
            and np.array_equal(self.write_sym, other.write_sym)
        )

    # -- serde shape conversions ------------------------------------------------

    def to_steps(self) -> List[Dict[str, Any]]:
        """Convert to the serde `Vec<StepProjection>` shape."""
        n, tau = self.n_steps, self.tau
        imv = self.input_mv.tolist()
        tmv = self.tape_mv.tolist()
        wf = self.write_flag.tolist()
        ws = self.write_sym.tolist()
        steps = []
        for i in range(n):
            tapes = [
                {"write": (int(ws[i][r]) if wf[i][r] else None), "mv": int(tmv[i][r])}
                for r in range(tau)
            ]
            steps.append({"input_mv": int(imv[i]), "tapes": tapes})
        return steps

    @staticmethod
    def from_steps(steps: List[Dict[str, Any]], tau: Optional[int] = None) -> "MovementLog":
        n = len(steps)
        if tau is None:
            tau = len(steps[0]["tapes"]) if n else 0
        input_mv = np.zeros(n, dtype=np.int8)
        tape_mv = np.zeros((n, tau), dtype=np.int8)
        write_flag = np.zeros((n, tau), dtype=bool)
        write_sym = np.zeros((n, tau), dtype=np.uint16)
        for i, st in enumerate(steps):
            input_mv[i] = st["input_mv"]
            for r, op in enumerate(st["tapes"]):
                tape_mv[i, r] = op["mv"]
                w = op.get("write")
                if w is not None:
                    write_flag[i, r] = True
                    write_sym[i, r] = w
        return MovementLog(input_mv, tape_mv, write_flag, write_sym)


@dataclass
class BlockSummary:
    """Per-block summary sigma_k (reference: crates/sezkp-core/src/types.rs:115-151)."""

    version: int
    block_id: int
    step_lo: int
    step_hi: int
    ctrl_in: int
    ctrl_out: int
    in_head_in: int
    in_head_out: int
    windows: np.ndarray  # int64 [tau, 2] -> (left, right)
    head_in_offsets: np.ndarray  # uint32 [tau]
    head_out_offsets: np.ndarray  # uint32 [tau]
    movement_log: MovementLog
    pre_tags: List[bytes] = field(default_factory=list)  # each 16 bytes
    post_tags: List[bytes] = field(default_factory=list)

    @property
    def tau(self) -> int:
        return int(self.windows.shape[0])

    @property
    def n_steps(self) -> int:
        return int(self.step_hi - self.step_lo + 1)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BlockSummary):
            return NotImplemented
        return (
            self.version == other.version
            and self.block_id == other.block_id
            and self.step_lo == other.step_lo
            and self.step_hi == other.step_hi
            and self.ctrl_in == other.ctrl_in
            and self.ctrl_out == other.ctrl_out
            and self.in_head_in == other.in_head_in
            and self.in_head_out == other.in_head_out
            and np.array_equal(self.windows, other.windows)
            and np.array_equal(self.head_in_offsets, other.head_in_offsets)
            and np.array_equal(self.head_out_offsets, other.head_out_offsets)
            and self.movement_log == other.movement_log
            and self.pre_tags == other.pre_tags
            and self.post_tags == other.post_tags
        )

    # -- serde shape ------------------------------------------------------------

    def to_obj(self) -> Dict[str, Any]:
        """Serde-compatible plain-object form (field order matters for CBOR)."""
        return {
            "version": int(self.version),
            "block_id": int(self.block_id),
            "step_lo": int(self.step_lo),
            "step_hi": int(self.step_hi),
            "ctrl_in": int(self.ctrl_in),
            "ctrl_out": int(self.ctrl_out),
            "in_head_in": int(self.in_head_in),
            "in_head_out": int(self.in_head_out),
            "windows": [
                {"left": int(l), "right": int(r)} for l, r in self.windows.tolist()
            ],
            "head_in_offsets": [int(x) for x in self.head_in_offsets.tolist()],
            "head_out_offsets": [int(x) for x in self.head_out_offsets.tolist()],
            "movement_log": {"steps": self.movement_log.to_steps()},
            "pre_tags": [list(t) for t in self.pre_tags],
            "post_tags": [list(t) for t in self.post_tags],
        }

    @staticmethod
    def from_obj(o: Dict[str, Any]) -> "BlockSummary":
        windows = np.array(
            [[w["left"], w["right"]] for w in o["windows"]], dtype=np.int64
        ).reshape(len(o["windows"]), 2)
        tau = windows.shape[0]
        return BlockSummary(
            version=o["version"],
            block_id=o["block_id"],
            step_lo=o["step_lo"],
            step_hi=o["step_hi"],
            ctrl_in=o["ctrl_in"],
            ctrl_out=o["ctrl_out"],
            in_head_in=o["in_head_in"],
            in_head_out=o["in_head_out"],
            windows=windows,
            head_in_offsets=np.asarray(o["head_in_offsets"], dtype=np.uint32),
            head_out_offsets=np.asarray(o["head_out_offsets"], dtype=np.uint32),
            movement_log=MovementLog.from_steps(o["movement_log"]["steps"], tau),
            pre_tags=[bytes(t) for t in o["pre_tags"]],
            post_tags=[bytes(t) for t in o["post_tags"]],
        )


@dataclass
class FiniteState:
    """Constant-size interval projection (reference: types.rs:190-208)."""

    ctrl_in: int = 0
    ctrl_out: int = 0
    in_head_in: int = 0
    in_head_out: int = 0
    work_head_in: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    work_head_out: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    flags: int = 0
    tag: bytes = b"\x00" * 16

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FiniteState):
            return NotImplemented
        return (
            self.ctrl_in == other.ctrl_in
            and self.ctrl_out == other.ctrl_out
            and self.in_head_in == other.in_head_in
            and self.in_head_out == other.in_head_out
            and np.array_equal(self.work_head_in, other.work_head_in)
            and np.array_equal(self.work_head_out, other.work_head_out)
            and self.flags == other.flags
            and self.tag == other.tag
        )

    @property
    def arity(self) -> int:
        return int(self.work_head_in.shape[0])


@dataclass(frozen=True)
class Window:
    left: int
    right: int

    def is_valid(self) -> bool:
        return self.right >= self.left

    def __len__(self) -> int:
        return max(0, self.right - self.left + 1)


@dataclass(frozen=True)
class Interval:
    """Closed interval of 1-based block indices [i, j]."""

    i: int
    j: int

    def __len__(self) -> int:
        return max(0, self.j - self.i + 1)
