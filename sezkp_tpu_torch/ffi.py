"""C-ABI surface (reference: crates/sezkp-ffi, a version-stub crate).

The reference exposes `sezkp_abi_version()` / `sezkp_version()` behind a
`cabi` feature; here the native library provides the same symbols and this
module mirrors them in Python for host embedding. Counterpart of
sezkp_tpu/ffi.py.
"""

from __future__ import annotations

ABI_VERSION = 1
VERSION = "0.1.0"


def sezkp_abi_version() -> int:
    return ABI_VERSION


def sezkp_version() -> str:
    return VERSION
