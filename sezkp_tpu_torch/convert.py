"""State carried across from the JAX package: blocks, field planes and
digest words.

There are no weights in this system; what both packages must agree on is the
input blocks and the numeric state. These helpers take the JAX package's
objects duck-typed (attributes and numpy arrays only, nothing of that package
is imported) and return this package's, so tests can run both on the same
inputs.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .core.types import BlockSummary, MovementLog
from .ops import goldilocks_torch as FT


def blocks_from_reference(blocks: Sequence) -> List[BlockSummary]:
    """BlockSummary-like objects (core/types.py of the JAX package) -> this
    package's BlockSummary, arrays copied."""
    out = []
    for b in blocks:
        ml = b.movement_log
        out.append(
            BlockSummary(
                version=int(b.version),
                block_id=int(b.block_id),
                step_lo=int(b.step_lo),
                step_hi=int(b.step_hi),
                ctrl_in=int(b.ctrl_in),
                ctrl_out=int(b.ctrl_out),
                in_head_in=int(b.in_head_in),
                in_head_out=int(b.in_head_out),
                windows=np.array(b.windows, dtype=np.int64),
                head_in_offsets=np.array(b.head_in_offsets, dtype=np.uint32),
                head_out_offsets=np.array(b.head_out_offsets, dtype=np.uint32),
                movement_log=MovementLog(
                    input_mv=np.array(ml.input_mv, dtype=np.int8),
                    tape_mv=np.array(ml.tape_mv, dtype=np.int8),
                    write_flag=np.array(ml.write_flag, dtype=bool),
                    write_sym=np.array(ml.write_sym, dtype=np.uint16),
                ),
                pre_tags=[bytes(t) for t in b.pre_tags],
                post_tags=[bytes(t) for t in b.post_tags],
            )
        )
    return out


def field_from_planes(lo, hi, device="cpu") -> torch.Tensor:
    """(lo, hi) uint32 planes of the JAX package -> int64 field tensor."""
    return FT.planes_to_field(np.asarray(lo), np.asarray(hi), device)


def planes_from_field(x: torch.Tensor):
    """int64 field tensor -> (lo, hi) uint32 numpy planes."""
    return FT.field_to_planes(x)


def cvs_from_planes(cv, device="cpu") -> torch.Tensor:
    """uint32 [8, N] (or [16, N]) digest/message word planes -> int32 tensor
    with the same bits."""
    a = np.ascontiguousarray(np.asarray(cv, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def planes_from_cvs(t: torch.Tensor) -> np.ndarray:
    """int32 word planes -> uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
