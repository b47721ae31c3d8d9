"""Minimal CBOR codec wire-compatible with the Rust reference's serializers.

The reference writes files with ``ciborium`` 0.2.2 and in-memory bundles with
``serde_cbor`` 0.11.2 (reference: crates/sezkp-core/src/io.rs, crates/sezkp-fold/src/lib.rs:142).
Both encode serde data the same way for the subset we need:

- structs            -> definite-length maps with text keys, declaration order
- Vec<T> / [T; N]    -> definite-length arrays (NO byte-string specialization,
                        so ``Vec<u8>``/``[u8;32]`` become arrays of small ints)
- Option<T>          -> ``null`` or the bare value
- unit enum variant  -> text string of the variant name
- newtype/struct enum variant -> {variant_name: value}
- integers           -> minimal-width encoding (major type 0/1)

We implement a generic value model (dict/list/int/str/bytes/bool/None/float)
plus helpers. Schema-specific encoding lives next to each dataclass.
"""

from __future__ import annotations

import functools
import struct
from typing import Any


@functools.cache
def native():
    """The C codec extension, built and loaded at the first call; None where
    it cannot be built.

    The extension is built from native/cbor_c.cpp into _build/ with the
    package's one g++ recipe (crypto.blake3.compile_native), on the first
    dumps/loads and never at import. It needs a C++ compiler and Python.h:
    where either is missing the pure-Python codec of this module serves
    (both emit and accept the same bytes). A compiler that is there and
    fails, or a built library that does not load, raises.

    The extension handles every encoding the pure-Python decoder does except
    tags (major type 6), for which it raises UnsupportedError and the caller
    falls back to the Python path for that value."""
    import importlib.machinery
    import importlib.util
    import os
    import shutil
    import sysconfig

    from ..crypto.blake3 import compile_native

    include = sysconfig.get_paths()["include"]
    if shutil.which(os.environ.get("CXX", "g++")) is None or not os.path.exists(
        os.path.join(include, "Python.h")
    ):
        return None
    so_path = compile_native(("cbor_c.cpp",), "sezkp_cbor_c.so", ("-I", include))
    loader = importlib.machinery.ExtensionFileLoader("sezkp_cbor_c", so_path)
    spec = importlib.util.spec_from_file_location("sezkp_cbor_c", so_path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    mod.set_tagged_class(Tagged)
    if hasattr(mod, "set_u8array_class"):
        mod.set_u8array_class(U8Array)
    return mod


__all__ = [
    "dumps",
    "loads",
    "CBORDecoder",
    "encode_into",
    "Tagged",
    "U8Array",
]


class Tagged:
    """A tagged CBOR value (major type 6)."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: int, value: Any):
        self.tag = tag
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover
        return f"Tagged({self.tag}, {self.value!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Tagged)
            and self.tag == other.tag
            and self.value == other.value
        )


class U8Array:
    """A serde ``[u8; N]`` held compactly as bytes but encoded as a CBOR
    ARRAY of small ints (serde's default array encoding — NOT a byte
    string). Building one of these is ~10x cheaper than a Python list of
    ints, which dominates large fold-bundle serialization otherwise."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = bytes(data)

    def __bytes__(self) -> bytes:
        return self.data

    def __iter__(self):
        return iter(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def __repr__(self) -> str:  # pragma: no cover
        return f"U8Array({self.data!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, U8Array):
            return self.data == other.data
        if isinstance(other, (list, tuple)):
            return list(self.data) == list(other)
        if isinstance(other, (bytes, bytearray)):
            return self.data == bytes(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.data)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _encode_head(out: bytearray, major: int, value: int) -> None:
    if value < 24:
        out.append((major << 5) | value)
    elif value < 0x100:
        out.append((major << 5) | 24)
        out.append(value)
    elif value < 0x10000:
        out.append((major << 5) | 25)
        out += value.to_bytes(2, "big")
    elif value < 0x100000000:
        out.append((major << 5) | 26)
        out += value.to_bytes(4, "big")
    else:
        out.append((major << 5) | 27)
        out += value.to_bytes(8, "big")


def encode_into(out: bytearray, obj: Any) -> None:
    """Encode ``obj`` into ``out`` using ciborium-compatible conventions.

    dicts keep their insertion order (Python dicts are ordered), matching
    serde's struct-field declaration order.
    """
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            _encode_head(out, 0, obj)
        else:
            _encode_head(out, 1, -1 - obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _encode_head(out, 3, len(b))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _encode_head(out, 2, len(b))
        out += b
    elif isinstance(obj, float):
        # ciborium encodes f64 as 64-bit float (no shortest-float search for
        # serde_json::Value numbers we care about).
        out.append(0xFB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, (list, tuple)):
        _encode_head(out, 4, len(obj))
        for item in obj:
            encode_into(out, item)
    elif isinstance(obj, dict):
        _encode_head(out, 5, len(obj))
        for k, v in obj.items():
            encode_into(out, k)
            encode_into(out, v)
    elif isinstance(obj, U8Array):
        _encode_head(out, 4, len(obj.data))
        for b in obj.data:
            _encode_head(out, 0, b)
    elif isinstance(obj, Tagged):
        _encode_head(out, 6, obj.tag)
        encode_into(out, obj.value)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)!r}")


def dumps(obj: Any) -> bytes:
    ext = native()
    if ext is not None:
        try:
            return ext.dumps(obj)
        except ext.UnsupportedError:
            pass  # exotic value: use the Python encoder (exact errors/bytes)
    out = bytearray()
    encode_into(out, obj)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class CBORDecoder:
    """Pull-decoder over a byte buffer; supports CBOR sequences (multiple
    back-to-back values, as used by the fold streaming proof format,
    reference: crates/sezkp-fold/src/driver.rs:354-412)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def at_end(self) -> bool:
        return self.pos >= len(self.data)

    def _read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("CBOR: unexpected end of input")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def _read_uint(self, info: int) -> int:
        if info < 24:
            return info
        if info == 24:
            return self._read(1)[0]
        if info == 25:
            return int.from_bytes(self._read(2), "big")
        if info == 26:
            return int.from_bytes(self._read(4), "big")
        if info == 27:
            return int.from_bytes(self._read(8), "big")
        raise ValueError(f"CBOR: unsupported additional info {info}")

    def decode(self) -> Any:
        ext = native()
        if ext is not None:
            try:
                v, self.pos = ext.decode_at(self.data, self.pos)
                return v
            except ext.UnsupportedError:
                pass  # tagged value: decode this one via the Python path
        return self._decode_py()

    def _decode_py(self) -> Any:
        ib = self._read(1)[0]
        major, info = ib >> 5, ib & 0x1F
        if major == 0:
            return self._read_uint(info)
        if major == 1:
            return -1 - self._read_uint(info)
        if major == 2:
            if info == 31:
                return self._decode_indefinite_bytes()
            return self._read(self._read_uint(info))
        if major == 3:
            if info == 31:
                return self._decode_indefinite_str()
            return self._read(self._read_uint(info)).decode("utf-8")
        if major == 4:
            if info == 31:
                return self._decode_indefinite_array()
            n = self._read_uint(info)
            return [self.decode() for _ in range(n)]
        if major == 5:
            if info == 31:
                return self._decode_indefinite_map()
            n = self._read_uint(info)
            return {self.decode(): self.decode() for _ in range(n)}
        if major == 6:
            return Tagged(self._read_uint(info), self.decode())
        # major == 7
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return None
        if info == 23:
            return None  # undefined -> None
        if info == 25:
            return _decode_half(self._read(2))
        if info == 26:
            return struct.unpack(">f", self._read(4))[0]
        if info == 27:
            return struct.unpack(">d", self._read(8))[0]
        raise ValueError(f"CBOR: unsupported simple value info={info}")

    def _decode_indefinite_bytes(self) -> bytes:
        chunks = []
        while True:
            if self.data[self.pos] == 0xFF:
                self.pos += 1
                break
            c = self.decode()
            if not isinstance(c, bytes):
                raise ValueError("CBOR: bad indefinite byte chunk")
            chunks.append(c)
        return b"".join(chunks)

    def _decode_indefinite_str(self) -> str:
        chunks = []
        while True:
            if self.data[self.pos] == 0xFF:
                self.pos += 1
                break
            c = self.decode()
            if not isinstance(c, str):
                raise ValueError("CBOR: bad indefinite text chunk")
            chunks.append(c)
        return "".join(chunks)

    def _decode_indefinite_array(self) -> list:
        out = []
        while True:
            if self.data[self.pos] == 0xFF:
                self.pos += 1
                break
            out.append(self.decode())
        return out

    def _decode_indefinite_map(self) -> dict:
        out = {}
        while True:
            if self.data[self.pos] == 0xFF:
                self.pos += 1
                break
            k = self.decode()
            out[k] = self.decode()
        return out


def _decode_half(b: bytes) -> float:
    h = int.from_bytes(b, "big")
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0**-24
    if exp == 31:
        return sign * (float("inf") if frac == 0 else float("nan"))
    return sign * (frac + 1024.0) * 2.0 ** (exp - 25)


def loads(data: bytes) -> Any:
    dec = CBORDecoder(data)
    v = dec.decode()
    if not dec.at_end():
        raise ValueError(f"CBOR: trailing bytes at {dec.pos}")
    return v


def loads_seq(data: bytes) -> list:
    """Decode a CBOR *sequence* (concatenated values) into a list."""
    dec = CBORDecoder(data)
    out = []
    while not dec.at_end():
        out.append(dec.decode())
    return out
