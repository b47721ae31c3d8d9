"""Streaming trace frontend: generate + partition + write in bounded chunks.

`simulate` previously materialized all T steps before partitioning (same
design as the reference's generator.rs + partition.rs, but the reference
still sweeps T to 2^27 — scripts/scale_streaming_sublinear.zsh:6-27 — while
a resident tau=8 trace is 8.6 GB at T=2^22). This module keeps RSS bounded
by the chunk size:

- the native ChaCha12 generator exposes a resumable state
  (sezkp_generate_trace_chunk; trace_gen.cpp), with a pure-Python stateful
  fallback (the same ChaChaRng object carried across chunks);
- partitioning runs per chunk with the carried global input-head prefix
  (block boundaries never span chunks: the chunk size is a multiple of b);
- blocks append to the output incrementally: JSONL lines directly; CBOR as
  a definite-length array whose header is written first (the block count
  ceil(t/b) is known up front) — output bytes are identical to
  write_block_summaries_auto on the materialized list (cross-tested).
"""

from __future__ import annotations

import ctypes
import json
from typing import Iterator, List, Tuple

import numpy as np

from ..core.types import BlockSummary, MovementLog
from ..utils import cbor

__all__ = ["simulate_stream", "iter_trace_chunks"]

_MV = (-1, 0, 1)


def _native_stream():
    from ..crypto import blake3 as b3

    if not b3.HAVE_NATIVE or not hasattr(b3._native, "sezkp_generate_trace_chunk"):
        return None
    lib = b3._native
    lib.sezkp_trace_state_size.restype = ctypes.c_size_t
    lib.sezkp_trace_state_init.argtypes = [ctypes.c_void_p]
    lib.sezkp_generate_trace_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def iter_trace_chunks(t: int, tau: int, chunk: int) -> Iterator[MovementLog]:
    """Yield the seed-42 synthetic trace in chunks of `chunk` steps (last
    one possibly shorter). Bit-exact with generator.generate_trace."""
    lib = _native_stream()
    if lib is not None:
        state = ctypes.create_string_buffer(lib.sezkp_trace_state_size())
        lib.sezkp_trace_state_init(state)
        done = 0
        while done < t:
            n = min(chunk, t - done)
            input_mv = np.zeros(n, dtype=np.int8)
            tape_mv = np.zeros((n, tau), dtype=np.int8)
            write_flag = np.zeros((n, tau), dtype=np.uint8)
            write_sym = np.zeros((n, tau), dtype=np.uint16)
            lib.sezkp_generate_trace_chunk(
                state, n, tau,
                input_mv.ctypes.data_as(ctypes.c_void_p),
                tape_mv.ctypes.data_as(ctypes.c_void_p),
                write_flag.ctypes.data_as(ctypes.c_void_p),
                write_sym.ctypes.data_as(ctypes.c_void_p),
            )
            yield MovementLog(input_mv, tape_mv, write_flag.astype(bool), write_sym)
            done += n
        return
    # pure-Python fallback: one stateful rng carried across chunks
    from .rng import ChaChaRng

    rng = ChaChaRng.std_rng(42)
    done = 0
    while done < t:
        n = min(chunk, t - done)
        input_mv = np.zeros(n, dtype=np.int8)
        tape_mv = np.zeros((n, tau), dtype=np.int8)
        write_flag = np.zeros((n, tau), dtype=bool)
        write_sym = np.zeros((n, tau), dtype=np.uint16)
        for i in range(n):
            input_mv[i] = _MV[rng.random_range_u32(0, 2)]
            for r in range(tau):
                if rng.random_bool(0.4):
                    write_flag[i, r] = True
                    write_sym[i, r] = rng.random_range_u16(0, 15)
                tape_mv[i, r] = _MV[rng.random_range_u32(0, 2)]
        yield MovementLog(input_mv, tape_mv, write_flag, write_sym)
        done += n


def _partition_chunk(ml: MovementLog, b: int, step0: int, in_head: int,
                     block_id0: int) -> Tuple[List[BlockSummary], int]:
    """partition_trace's per-block math on one chunk, with carried global
    offsets (step0 = absolute step index of the chunk start, in_head = the
    absolute input-head position there). Chunk length must be a multiple
    of b except for the final chunk."""
    t = ml.input_mv.shape[0]
    in_prefix = np.concatenate(
        [[in_head], in_head + np.cumsum(ml.input_mv.astype(np.int64))]
    )
    out: List[BlockSummary] = []
    k = block_id0
    for lo in range(0, t, b):
        hi = min(lo + b, t)
        mv = ml.tape_mv[lo:hi].astype(np.int64)
        heads = np.cumsum(mv, axis=0)
        min_pos = np.minimum(heads.min(axis=0), 0)
        max_pos = np.maximum(heads.max(axis=0), 0)
        cur = heads[-1]
        off_in = -min_pos
        off_out = cur - min_pos
        tau = ml.tape_mv.shape[1]
        out.append(
            BlockSummary(
                version=1,
                block_id=k,
                step_lo=step0 + lo + 1,
                step_hi=step0 + hi,
                ctrl_in=0,
                ctrl_out=0,
                in_head_in=int(in_prefix[lo]),
                in_head_out=int(in_prefix[hi]),
                windows=np.stack([min_pos, max_pos], axis=1).astype(np.int64),
                head_in_offsets=off_in.astype(np.uint32),
                head_out_offsets=off_out.astype(np.uint32),
                movement_log=MovementLog(
                    ml.input_mv[lo:hi].copy(), ml.tape_mv[lo:hi].copy(),
                    ml.write_flag[lo:hi].copy(), ml.write_sym[lo:hi].copy(),
                ),
                pre_tags=[b"\x00" * 16] * tau,
                post_tags=[b"\x00" * 16] * tau,
            )
        )
        k += 1
    return out, int(in_prefix[-1])


def _encode_log_rows(ml: MovementLog) -> np.ndarray | None:
    """Vectorized CBOR encoding of a chunk's movement log: one fixed-width
    byte row per step (the serde layout
    {"input_mv": i, "tapes": [{"write": s|null, "mv": m}, ...]} is
    constant-length whenever every value is a 1-byte CBOR item: moves in
    {-1, 0, 1} encode as 0x20/0x00/0x01, write as 0xf6 (null) or a
    single-byte uint <= 23). Returns [n, 18 + 12 tau] u8, or None when a
    value falls outside the 1-byte forms (caller falls back to the generic
    encoder). ~40x faster than per-int Python encoding; output bytes are
    identical (cross-tested in tests/test_trace.py)."""
    n, tau = ml.input_mv.shape[0], ml.tape_mv.shape[1]
    if tau > 23 or n == 0:
        return None
    imv = ml.input_mv
    tmv = ml.tape_mv
    ws = ml.write_sym
    if (
        imv.min() < -1 or imv.max() > 1
        or tmv.min() < -1 or tmv.max() > 1
        or (ml.write_flag.any() and ws[ml.write_flag].max() > 23)
    ):
        return None

    def mv_byte(a):
        a = a.astype(np.int16)
        return np.where(a < 0, 0x20, a).astype(np.uint8)

    # constant template row broadcast once (one pass over the output),
    # then only the variable byte columns are scattered in
    tpl = np.zeros(18 + 12 * tau, dtype=np.uint8)
    tpl[0] = 0xA2
    tpl[1] = 0x68
    tpl[2:10] = np.frombuffer(b"input_mv", dtype=np.uint8)
    tpl[11] = 0x65
    tpl[12:17] = np.frombuffer(b"tapes", dtype=np.uint8)
    tpl[17] = 0x80 | tau
    for r in range(tau):
        base = 18 + 12 * r
        tpl[base] = 0xA2
        tpl[base + 1] = 0x65
        tpl[base + 2:base + 7] = np.frombuffer(b"write", dtype=np.uint8)
        tpl[base + 8] = 0x62
        tpl[base + 9:base + 11] = np.frombuffer(b"mv", dtype=np.uint8)
    rows = np.broadcast_to(tpl, (n, tpl.shape[0])).copy()
    rows[:, 10] = mv_byte(imv)
    wbyte = np.where(ml.write_flag, ws.astype(np.uint16), 0xF6).astype(np.uint8)
    rows[:, 25::12] = wbyte
    rows[:, 29::12] = mv_byte(tmv)
    return rows


_TAG_CACHE: dict = {}


def _tags_bytes(tags) -> bytes:
    """Cached CBOR bytes of [list(t) for t in tags] (tags are constant
    per partition run — 16 zero bytes each — so one encode serves every
    block)."""
    key = tuple(tags)
    hit = _TAG_CACHE.get(key)
    if hit is None:
        buf = bytearray()
        cbor.encode_into(buf, [list(t) for t in tags])
        hit = _TAG_CACHE[key] = bytes(buf)
        if len(_TAG_CACHE) > 16:
            _TAG_CACHE.clear()
            _TAG_CACHE[key] = hit
    return hit


def _encode_block_fast(blk: BlockSummary, log_rows: np.ndarray) -> bytes:
    """CBOR-encode one block using pre-encoded movement-log rows, emitting
    exactly the bytes of cbor.encode_into(blk.to_obj()) (field order and
    head encodings identical; envelope fields go through the generic
    encoder, only the per-step log bytes are spliced in)."""
    buf = bytearray()
    cbor._encode_head(buf, 5, 14)  # 14-key block map
    env = {
        "version": int(blk.version),
        "block_id": int(blk.block_id),
        "step_lo": int(blk.step_lo),
        "step_hi": int(blk.step_hi),
        "ctrl_in": int(blk.ctrl_in),
        "ctrl_out": int(blk.ctrl_out),
        "in_head_in": int(blk.in_head_in),
        "in_head_out": int(blk.in_head_out),
        "windows": [
            {"left": int(l), "right": int(r)} for l, r in blk.windows.tolist()
        ],
        "head_in_offsets": [int(x) for x in blk.head_in_offsets.tolist()],
        "head_out_offsets": [int(x) for x in blk.head_out_offsets.tolist()],
    }
    for k, v in env.items():
        cbor.encode_into(buf, k)
        cbor.encode_into(buf, v)
    cbor.encode_into(buf, "movement_log")
    cbor._encode_head(buf, 5, 1)
    cbor.encode_into(buf, "steps")
    cbor._encode_head(buf, 4, log_rows.shape[0])
    buf += log_rows.tobytes()
    cbor.encode_into(buf, "pre_tags")
    buf += _tags_bytes(blk.pre_tags)
    cbor.encode_into(buf, "post_tags")
    buf += _tags_bytes(blk.post_tags)
    return bytes(buf)


def simulate_stream(t: int, b: int, tau: int, out_path: str,
                    chunk_steps: int | None = None) -> int:
    """Generate, partition, and write the blocks file in bounded chunks.

    Returns the block count. Output bytes are identical to
    `write_block_summaries_auto(path, partition_trace(generate_trace(t,
    tau), b))` for both .cbor and .jsonl (cross-tested)."""
    if chunk_steps is None:
        # ~80 MB of resident movement log at tau=8
        chunk_steps = 1 << 21
    chunk_steps = max(b, (chunk_steps // b) * b)
    n_blocks = -(-t // b)
    ext = out_path.rsplit(".", 1)[-1].lower()

    if ext == "cbor":
        head = bytearray()
        cbor._encode_head(head, 4, n_blocks)  # definite-length array
        with open(out_path, "wb") as f:
            f.write(bytes(head))
            in_head = 0
            step0 = 0
            bid = 1
            for ml in iter_trace_chunks(t, tau, chunk_steps):
                blocks, in_head = _partition_chunk(ml, b, step0, in_head, bid)
                n_chunk = ml.input_mv.shape[0]
                log_rows = _encode_log_rows(ml)
                if log_rows is not None:
                    for i, blk in enumerate(blocks):
                        lo = i * b
                        hi = min(lo + b, n_chunk)
                        f.write(_encode_block_fast(blk, log_rows[lo:hi]))
                else:
                    buf = bytearray()
                    for blk in blocks:
                        cbor.encode_into(buf, blk.to_obj())
                    f.write(buf)
                step0 += n_chunk
                bid += len(blocks)
    elif ext in ("jsonl", "ndjson"):
        with open(out_path, "w") as f:
            in_head = 0
            step0 = 0
            bid = 1
            for ml in iter_trace_chunks(t, tau, chunk_steps):
                blocks, in_head = _partition_chunk(ml, b, step0, in_head, bid)
                step0 += ml.input_mv.shape[0]
                bid += len(blocks)
                for blk in blocks:
                    json.dump(blk.to_obj(), f, separators=(",", ":"))
                    f.write("\n")
    else:
        raise ValueError(
            f"simulate_stream supports .cbor/.jsonl outputs (got .{ext})"
        )
    return n_blocks
