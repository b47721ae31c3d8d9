"""Deterministic synthetic trace generator.

Bit-exact with the reference (crates/sezkp-trace/src/generator.rs:38-73):
StdRng seeded with 42; per step draw input_mv in {-1,0,1}; per tape draw
write with prob 0.4 (symbol 0..=15) then mv in {-1,0,1}.
"""

from __future__ import annotations

import numpy as np

from ..core.types import MovementLog
from .format import TraceFile
from .rng import ChaChaRng

__all__ = ["generate_trace"]

_MV = (-1, 0, 1)


def _generate_native(t: int, tau: int):
    """Fast path via the native library (bit-exact; cross-tested)."""
    import ctypes

    from ..crypto import blake3 as b3

    if not b3.HAVE_NATIVE or not hasattr(b3._native, "sezkp_generate_trace"):
        return None
    lib = b3._native
    lib.sezkp_generate_trace.argtypes = [
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    input_mv = np.zeros(t, dtype=np.int8)
    tape_mv = np.zeros((t, tau), dtype=np.int8)
    write_flag = np.zeros((t, tau), dtype=np.uint8)
    write_sym = np.zeros((t, tau), dtype=np.uint16)
    lib.sezkp_generate_trace(
        t,
        tau,
        input_mv.ctypes.data_as(ctypes.c_void_p),
        tape_mv.ctypes.data_as(ctypes.c_void_p),
        write_flag.ctypes.data_as(ctypes.c_void_p),
        write_sym.ctypes.data_as(ctypes.c_void_p),
    )
    return input_mv, tape_mv, write_flag.astype(bool), write_sym


def generate_trace(t: int, tau: int) -> TraceFile:
    native = _generate_native(t, tau)
    if native is not None:
        input_mv, tape_mv, write_flag, write_sym = native
    else:
        rng = ChaChaRng.std_rng(42)
        input_mv = np.zeros(t, dtype=np.int8)
        tape_mv = np.zeros((t, tau), dtype=np.int8)
        write_flag = np.zeros((t, tau), dtype=bool)
        write_sym = np.zeros((t, tau), dtype=np.uint16)
        for i in range(t):
            input_mv[i] = _MV[rng.random_range_u32(0, 2)]
            for r in range(tau):
                if rng.random_bool(0.4):
                    write_flag[i, r] = True
                    write_sym[i, r] = rng.random_range_u16(0, 15)
                tape_mv[i, r] = _MV[rng.random_range_u32(0, 2)]

    return TraceFile(
        version=1,
        tau=tau,
        steps=MovementLog(input_mv, tape_mv, write_flag, write_sym),
        meta=None,
    )


def generate_trace_python(t: int, tau: int) -> TraceFile:
    """Pure-Python generator (parity oracle for the native path)."""
    rng = ChaChaRng.std_rng(42)
    input_mv = np.zeros(t, dtype=np.int8)
    tape_mv = np.zeros((t, tau), dtype=np.int8)
    write_flag = np.zeros((t, tau), dtype=bool)
    write_sym = np.zeros((t, tau), dtype=np.uint16)
    for i in range(t):
        input_mv[i] = _MV[rng.random_range_u32(0, 2)]
        for r in range(tau):
            if rng.random_bool(0.4):
                write_flag[i, r] = True
                write_sym[i, r] = rng.random_range_u16(0, 15)
            tape_mv[i, r] = _MV[rng.random_range_u32(0, 2)]
    return TraceFile(
        version=1,
        tau=tau,
        steps=MovementLog(input_mv, tape_mv, write_flag, write_sym),
        meta=None,
    )
