"""Serialization of block summaries and proof artifacts.

JSON/CBOR/JSONL with extension auto-detect, mirroring the reference's I/O
surface (crates/sezkp-core/src/io.rs, io_jsonl.rs). CBOR bytes are
bit-compatible with ciborium; JSON is read/write compatible (whitespace may
differ, which nothing hashes).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, List, Sequence

from ..utils import cbor
from .artifact import ProofArtifact
from .types import BlockSummary

__all__ = [
    "read_block_summaries_auto",
    "write_block_summaries_auto",
    "stream_block_summaries_auto",
    "stream_block_summaries_jsonl",
    "write_block_summaries_jsonl",
    "read_proof_auto",
    "write_proof_auto",
]


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower().lstrip(".")


def _ensure_parent(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


# ------------------------------ blocks ------------------------------------


def read_block_summaries_auto(path: str) -> List[BlockSummary]:
    e = _ext(path)
    with open(path, "rb") as f:
        data = f.read()
    if e == "json":
        objs = json.loads(data)
    elif e == "cbor":
        objs = cbor.loads(data)
    else:
        raise ValueError(f"unsupported blocks extension: {e} (expected .json/.cbor)")
    return [BlockSummary.from_obj(o) for o in objs]


def write_block_summaries_auto(path: str, blocks: Sequence[BlockSummary]) -> None:
    e = _ext(path)
    _ensure_parent(path)
    objs = [b.to_obj() for b in blocks]
    if e == "cbor":
        with open(path, "wb") as f:
            f.write(cbor.dumps(objs))
    elif e in ("jsonl", "ndjson"):
        write_block_summaries_jsonl(path, blocks)
    else:
        with open(path, "w") as f:
            json.dump(objs, f, indent=2)


def stream_block_summaries_jsonl(path: str) -> Iterator[BlockSummary]:
    with open(path, "r") as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\r\n")
            if not line:
                raise ValueError(f"parse jsonl line {line_no}: empty line")
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"parse jsonl line {line_no}: {e}") from e
            yield BlockSummary.from_obj(obj)


def write_block_summaries_jsonl(path: str, blocks: Iterable[BlockSummary]) -> None:
    _ensure_parent(path)
    with open(path, "w") as f:
        for b in blocks:
            json.dump(b.to_obj(), f, separators=(",", ":"))
            f.write("\n")


def stream_block_summaries_cbor(
    path: str, window_bytes: int = 1 << 23
) -> Iterator[BlockSummary]:
    """Stream a definite-length CBOR array of block maps with bounded RSS.

    Keeps a rolling window of at most ~window_bytes + one block in memory:
    decode one element at a time, and when a block straddles the window's
    end, drop the consumed prefix and refill from the file. Matches the
    reference's streaming ethos for its native .cbor block format
    (crates/sezkp-core reads blocks incrementally on the fold line); the
    resident reader materialized the whole file, which forced the RSS
    scaling suite onto JSONL."""
    with open(path, "rb") as f:
        buf = bytearray(f.read(window_bytes))
        dec = cbor.CBORDecoder(bytes(buf))
        ib = dec._read(1)[0]
        major, info = ib >> 5, ib & 0x1F
        if major != 4 or info == 31:
            raise ValueError("streaming cbor blocks: expected definite array")
        count = dec._read_uint(info)
        pos = dec.pos
        data = bytes(buf)
        for _ in range(count):
            while True:
                d = cbor.CBORDecoder(data, pos)
                try:
                    obj = d.decode()
                    break
                except ValueError as e:
                    # Retry with more bytes only on genuine truncation (both
                    # the native and Python decoders raise exactly this
                    # message when a read runs past the buffer); corruption
                    # raises immediately instead of refilling to EOF with
                    # quadratic copying.
                    if str(e) != "CBOR: unexpected end of input":
                        raise
                    more = f.read(window_bytes)
                    if not more:
                        raise
                    data = data[pos:] + more
                    pos = 0
            pos = d.pos
            if pos > window_bytes:
                # drop the consumed prefix so the window stays bounded
                data = data[pos:]
                pos = 0
            yield BlockSummary.from_obj(obj)
        # strictness parity with the resident reader (cbor.loads raises
        # "trailing bytes"): the array's last element must end the file
        if pos != len(data) or f.read(1):
            raise ValueError(f"CBOR: trailing bytes at {pos}")


def stream_block_summaries_auto(path: str) -> Iterator[BlockSummary]:
    e = _ext(path)
    if e in ("jsonl", "ndjson"):
        return stream_block_summaries_jsonl(path)
    if e == "cbor":
        return stream_block_summaries_cbor(path)
    if e == "json":
        return iter(read_block_summaries_auto(path))
    raise ValueError(f"unsupported blocks extension: {e}")


# ------------------------------ proofs ------------------------------------


def read_proof_auto(path: str) -> ProofArtifact:
    e = _ext(path)
    with open(path, "rb") as f:
        data = f.read()
    if e == "json":
        return ProofArtifact.from_obj(json.loads(data))
    if e == "cbor":
        return ProofArtifact.from_obj(cbor.loads(data))
    raise ValueError(f"unsupported proof extension: {e}")


def write_proof_auto(path: str, art: ProofArtifact) -> None:
    e = _ext(path)
    _ensure_parent(path)
    if e == "cbor":
        with open(path, "wb") as f:
            f.write(cbor.dumps(art.to_obj()))
    else:
        with open(path, "w") as f:
            json.dump(art.to_obj(), f, indent=2)


# ------------------------- tiny versioned wrapper ---------------------------


class Versioned:
    """Version-tagged payload wrapper (reference: core/io.rs Versioned<T>)."""

    __slots__ = ("ver", "payload")

    def __init__(self, ver: int, payload):
        self.ver = ver
        self.payload = payload

    def to_obj(self):
        return {"ver": self.ver, "payload": self.payload}

    @staticmethod
    def from_obj(o) -> "Versioned":
        return Versioned(o["ver"], o["payload"])


def to_cbor(value) -> bytes:
    """Serialize a plain object tree to CBOR (reference: core/io.rs to_cbor)."""
    return cbor.dumps(value)


def from_cbor(data: bytes):
    return cbor.loads(data)
