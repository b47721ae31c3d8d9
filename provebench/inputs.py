"""Seeded inputs: a pool of distinct traces, their blocks and manifest roots.

The generator keeps the distribution of the program's synthetic traces
(crates/sezkp-trace/src/generator.rs): the input move and each tape's move
uniform over {-1, 0, 1}, a write on each tape with probability 0.4, its
symbol uniform over 0..14. It draws from numpy's generator seeded with the
run's seed, so the same seed gives the same pool and another seed another
one; every seed gives traces of the same length and tape count.

The blocks and the manifest root come from the plain reference's partition
and manifest commit (plain/trace.py), and the program gets the same arrays in
its own block type: read-only views of one trace, as the program's own
partitioner hands them out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

from plain.trace import Log, manifest_root, partition


@dataclass
class Input:
    """One trace of the pool: the reference's blocks, the program's blocks
    (same arrays) and the manifest root both are proved against."""

    ref_blocks: List[Any]
    blocks: List[Any]
    root: bytes
    steps: int


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number, negative and past 64 bits included."""
    return np.random.SeedSequence([abs(seed), int(seed < 0)])


def make_trace(rng: np.random.Generator, t: int, tau: int) -> Log:
    input_mv = rng.integers(-1, 2, size=t, dtype=np.int8)
    tape_mv = rng.integers(-1, 2, size=(t, tau), dtype=np.int8)
    write_flag = rng.random((t, tau)) < 0.4
    syms = rng.integers(0, 15, size=(t, tau), dtype=np.uint16)
    write_sym = np.where(write_flag, syms, np.uint16(0)).astype(np.uint16)
    for a in (input_mv, tape_mv, write_flag, write_sym):
        a.flags.writeable = False
    return Log(input_mv, tape_mv, write_flag, write_sym)


def to_program_blocks(ref_blocks, types) -> list:
    """The same blocks in the program's types (`types` is the program's
    core.types module); the arrays are shared, not copied."""
    out = []
    for b in ref_blocks:
        ml = b.movement_log
        out.append(types.BlockSummary(
            version=b.version, block_id=b.block_id, step_lo=b.step_lo, step_hi=b.step_hi,
            ctrl_in=b.ctrl_in, ctrl_out=b.ctrl_out,
            in_head_in=b.in_head_in, in_head_out=b.in_head_out,
            windows=b.windows, head_in_offsets=b.head_in_offsets,
            head_out_offsets=b.head_out_offsets,
            movement_log=types.MovementLog(ml.input_mv, ml.tape_mv, ml.write_flag, ml.write_sym),
            pre_tags=list(b.pre_tags), post_tags=list(b.post_tags),
        ))
    return out


def make_pool(seed: int, t: int, block_steps: int, tau: int, pool: int, types) -> List[Input]:
    """`pool` distinct traces of `t` steps on `tau` tapes, cut into blocks
    of `block_steps` steps."""
    rngs = [np.random.default_rng(s) for s in seed_sequence(seed).spawn(pool)]
    out = []
    for rng in rngs:
        ml = make_trace(rng, t, tau)
        ref_blocks = partition(ml, block_steps)
        root = manifest_root(ref_blocks)
        out.append(Input(ref_blocks, to_program_blocks(ref_blocks, types), root, t))
    return out
