"""The sharded prover's host orchestration, first piece: the raw inputs of
the in-kernel column derivation, per rank.

Counterpart of ``raw_shard_args`` in sezkp_tpu/parallel/prove_sharded.py
(the rest of that module, ``ShardedPipeline`` and ``ShardedFri``, is still
to be ported). Built on the port's own ``columns_device._host_inputs`` and
its packed movement logs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..stark.v1.columns_device import _block_table, _host_inputs, _unpack_logs, derive_cols_core, pack_logs
from .mesh import Mesh, make_global


class RawShard(NamedTuple):
    """This rank's raw inputs of the column derivation, on its device: the
    per-row arrays cut to its rows (input_mv, the movement logs, block_of,
    is_first, is_last), the per-block tables (int64 [tau, nb]: win_len,
    in_off, out_off; int32 anchor) replicated, and `carry`, the exclusive
    tape-mv sum at its first row (int32 [tau]). `logs` is (packed u8
    [tau, n/D],) when `packed`, else (tape_mv i8, wflag u8, wsym i32)."""

    input_mv: torch.Tensor
    logs: Tuple[torch.Tensor, ...]
    packed: bool
    block_of: torch.Tensor
    is_first: torch.Tensor
    is_last: torch.Tensor
    win_len: torch.Tensor
    in_off: torch.Tensor
    out_off: torch.Tensor
    anchor: torch.Tensor
    carry: torch.Tensor

    def derive(self) -> torch.Tensor:
        """This rank's [C, n/D] column slab (all_labels order)."""
        tmv, wfl, wsy = _unpack_logs(self.logs[0]) if self.packed else self.logs
        return derive_cols_core(
            self.input_mv, tmv, wfl, wsy, self.block_of, self.is_first, self.is_last,
            self.win_len, self.in_off, self.out_off, self.anchor, self.carry,
        )


def raw_shard_args(mesh: Mesh, d: int, blocks) -> RawShard:
    """The raw program inputs of the in-kernel column derivation for this
    rank: per-row arrays sharded over the ranks, per-block tables and cumsum
    anchors replicated. The per-shard carry handles shard boundaries that
    fall inside a block (partial within-block sums)."""
    if d != mesh.size:
        raise ValueError(f"d = {d} is not the world's size {mesh.size}")
    h = _host_inputs(blocks)
    n, tau = h["n"], h["tau"]
    # exclusive tape-mv cumsum at each block start, via per-block sums
    # (no O(n*tau) i32 cumsum materialization)
    bs = h["block_start"]
    block_sums = np.add.reduceat(
        h["tape_mv"].astype(np.int64), bs, axis=0
    )  # [nb, tau]
    anchor = ((np.cumsum(block_sums, axis=0) - block_sums).T).astype(
        np.int32
    )  # [tau, nb]
    nloc = n // d
    starts = np.arange(d, dtype=np.int64) * nloc
    sb = np.searchsorted(bs, starts, side="right") - 1
    parts = np.stack(
        [
            h["tape_mv"][bs[sb[i]] : starts[i]].astype(np.int64).sum(axis=0)
            for i in range(d)
        ],
        axis=1,
    ).reshape(tau, d)  # [tau, D]
    carry_shard = (anchor[:, sb].astype(np.int64) + parts).astype(np.int32)
    # pack (tape_mv, write_flag, write_sym) into one u8 plane when the symbol
    # fits 4 bits, as DeviceColumns does
    packed = (
        n > 0
        and int(h["wsym"].max(initial=0)) <= 15
        and int(h["tape_mv"].min(initial=0)) >= -1
        and int(h["tape_mv"].max(initial=0)) <= 1
    )
    if packed:
        logs = (pack_logs(h["tape_mv"].T, h["wflag"].T, h["wsym"].T),)
    else:
        logs = (h["tape_mv"].T, h["wflag"].astype(np.uint8).T, h["wsym"].astype(np.int32).T)
    return RawShard(
        input_mv=make_global(mesh, 0, h["input_mv"]),
        logs=tuple(make_global(mesh, 1, a) for a in logs),
        packed=packed,
        block_of=make_global(mesh, 0, h["block_of"]),
        is_first=make_global(mesh, 0, h["is_first"]),
        is_last=make_global(mesh, 0, h["is_last"]),
        win_len=make_global(mesh, None, _block_table(h["win_len"])),
        in_off=make_global(mesh, None, _block_table(h["in_off"])),
        out_off=make_global(mesh, None, _block_table(h["out_off"])),
        anchor=make_global(mesh, None, anchor),
        carry=make_global(mesh, None, carry_shard[:, mesh.rank]),
    )
