"""Backend/model registry.

The proving "model families" supported by the framework, addressable by name
(the reference exposes these via CLI backend flags and crate types):

- ``stark-v0``: streaming row-commitment scaffold (crates/sezkp-stark v0)
- ``stark-v1``: columnar PIOP + DEEP coset LDE + FRI (crates/sezkp-stark v1)
- ``fold``:     Leaf/Fold/Wrap accumulation line (crates/sezkp-fold)

plus the demo VM adapter (`vm_riscv`). Counterpart of sezkp_tpu/models: the
names resolve to the port's backends.
"""

from __future__ import annotations

__all__ = ["get_backend", "BACKENDS"]


def get_backend(name: str):
    if name in ("fold", "fold-v2"):
        from ..fold.backend import FoldBackend

        return FoldBackend
    if name in ("stark", "stark-v1", "v1"):
        from ..stark.backends import StarkV1

        return StarkV1
    if name in ("stark-v0", "v0"):
        from ..stark.backends import StarkIOP

        return StarkIOP
    raise KeyError(f"unknown backend: {name}")


BACKENDS = ("fold", "stark-v1", "stark-v0")
