"""BLAKE3 front-end: native C++ library when available, pure Python otherwise.

Exposes a hashlib-like :class:`Hasher` (update/copy/digest with XOF lengths)
plus batch helpers used by the Merkle/commitment layers:

- :func:`hash_bytes`       one message -> digest (arbitrary output length)
- :func:`hash_many`        N equal-length messages -> N x 32B (contiguous numpy)
- :func:`parent_many`      N 64B sibling pairs -> N x 32B
- :func:`merkle_root_leaves`  left-balanced odd-promotion root over leaf hashes

The on-device batched hasher lives in :mod:`sezkp_tpu_torch.ops.blake3_torch`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from . import blake3_py

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "native"))
_BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "_build"))
_LIB_PATH = os.path.join(_BUILD_DIR, "libsezkp_blake3.so")

_lib: Optional[ctypes.CDLL] = None


def compile_native(sources, lib_name: str, extra_flags=()) -> str:
    """Compile sources of this package's native/ directory with g++ into
    _build/<lib_name> (if it is not there yet) and return the path.

    Raises when the compiler is missing or fails. The library is written
    under a private name and renamed into place, so concurrent processes building it
    (several test workers on a fresh checkout) never load a partial file."""
    path = os.path.join(_BUILD_DIR, lib_name)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    stem, ext = os.path.splitext(lib_name)
    tmp = os.path.join(_BUILD_DIR, f"{stem}.{os.getpid()}.tmp{ext}")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-fPIC", "-shared", "-std=c++17", "-march=native", "-fno-exceptions",
        *extra_flags, "-o", tmp,
        *(os.path.join(_NATIVE_DIR, src) for src in sources),
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    os.replace(tmp, path)
    return path


def build_native() -> str:
    """Compile native/blake3.cpp and native/trace_gen.cpp into
    _build/libsezkp_blake3.so and return the path."""
    return compile_native(("blake3.cpp", "trace_gen.cpp"), os.path.basename(_LIB_PATH))


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            build_native()
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.b3_hash.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.b3_new.restype = ctypes.c_void_p
    lib.b3_copy.argtypes = [ctypes.c_void_p]
    lib.b3_copy.restype = ctypes.c_void_p
    lib.b3_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.b3_finalize.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.b3_free.argtypes = [ctypes.c_void_p]
    lib.b3_hash_many.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.c_void_p,
    ]
    lib.b3_parent_many.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.b3_merkle_root.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    _lib = lib
    return lib


_native = _load_native()

HAVE_NATIVE = _native is not None


class _NativeHasher:
    __slots__ = ("_h",)

    def __init__(self, _raw=None):
        self._h = _raw if _raw is not None else _native.b3_new()

    def update(self, data: bytes) -> "_NativeHasher":
        _native.b3_update(self._h, bytes(data), len(data))
        return self

    def copy(self) -> "_NativeHasher":
        return _NativeHasher(_native.b3_copy(self._h))

    def digest(self, length: int = 32) -> bytes:
        out = ctypes.create_string_buffer(length)
        _native.b3_finalize(self._h, out, length)
        return out.raw

    def __del__(self):  # pragma: no cover
        try:
            _native.b3_free(self._h)
        except Exception:
            pass


Hasher = _NativeHasher if HAVE_NATIVE else blake3_py.Blake3


def hash_bytes(data: bytes, length: int = 32) -> bytes:
    if HAVE_NATIVE:
        out = ctypes.create_string_buffer(length)
        _native.b3_hash(bytes(data), len(data), out, length)
        return out.raw
    return blake3_py.blake3_hash(data, length)


def hash_many(messages: np.ndarray) -> np.ndarray:
    """Hash N equal-length messages. ``messages``: uint8 array [N, L] (C-order).

    Returns uint8 array [N, 32].
    """
    msgs = np.ascontiguousarray(messages, dtype=np.uint8)
    n, msg_len = msgs.shape
    out = np.empty((n, 32), dtype=np.uint8)
    if n == 0:
        return out
    if HAVE_NATIVE:
        _native.b3_hash_many(
            msgs.ctypes.data_as(ctypes.c_void_p), n, msg_len, out.ctypes.data_as(ctypes.c_void_p)
        )
    else:
        for i in range(n):
            out[i] = np.frombuffer(blake3_py.blake3_hash(msgs[i].tobytes()), dtype=np.uint8)
    return out


def parent_many(pairs: np.ndarray) -> np.ndarray:
    """Hash N concatenated 32B||32B sibling pairs. ``pairs``: uint8 [N, 64]."""
    ps = np.ascontiguousarray(pairs, dtype=np.uint8)
    n = ps.shape[0]
    out = np.empty((n, 32), dtype=np.uint8)
    if n == 0:
        return out
    if HAVE_NATIVE:
        _native.b3_parent_many(
            ps.ctypes.data_as(ctypes.c_void_p), n, out.ctypes.data_as(ctypes.c_void_p)
        )
    else:
        for i in range(n):
            out[i] = np.frombuffer(blake3_py.blake3_hash(ps[i].tobytes()), dtype=np.uint8)
    return out


def merkle_root_leaves(leaves: np.ndarray) -> bytes:
    """Left-balanced Merkle root with odd-promotion over uint8 [N, 32] leaves.

    Matches reference crates/sezkp-merkle/src/lib.rs:140-157 (empty -> zeros).
    """
    lv = np.ascontiguousarray(leaves, dtype=np.uint8)
    n = lv.shape[0]
    out = np.zeros(32, dtype=np.uint8)
    if n == 0:
        return out.tobytes()
    if HAVE_NATIVE:
        _native.b3_merkle_root(
            lv.ctypes.data_as(ctypes.c_void_p), n, out.ctypes.data_as(ctypes.c_void_p)
        )
        return out.tobytes()
    cur = lv
    while cur.shape[0] > 1:
        m = cur.shape[0]
        half = m // 2
        pairs = cur[: 2 * half].reshape(half, 64)
        nxt = parent_many(pairs)
        if m & 1:
            nxt = np.concatenate([nxt, cur[-1:]], axis=0)
        cur = nxt
    return cur[0].tobytes()
