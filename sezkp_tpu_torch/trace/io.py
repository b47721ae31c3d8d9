"""Trace file I/O (JSON/CBOR auto-detect; reference: crates/sezkp-trace/src/io.rs)."""

from __future__ import annotations

import json
import os

from ..utils import cbor
from .format import TraceFile

__all__ = ["read_trace_auto", "write_trace_auto"]


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower().lstrip(".")


def read_trace_auto(path: str) -> TraceFile:
    e = _ext(path)
    with open(path, "rb") as f:
        data = f.read()
    if e == "json":
        return TraceFile.from_obj(json.loads(data))
    if e == "cbor":
        return TraceFile.from_obj(cbor.loads(data))
    raise ValueError(f"unsupported trace extension: {e}")


def write_trace_auto(path: str, tf: TraceFile) -> None:
    e = _ext(path)
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    if e == "cbor":
        with open(path, "wb") as f:
            f.write(cbor.dumps(tf.to_obj()))
    else:
        with open(path, "w") as f:
            json.dump(tf.to_obj(), f, indent=2)
