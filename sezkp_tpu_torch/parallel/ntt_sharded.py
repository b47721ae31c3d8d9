"""Distributed four-step NTT over a 1-D world of ranks.

Counterpart of sezkp_tpu/parallel/ntt_sharded.py. Decompose n = n1 * n2 and
view the coefficient vector as A[j1, j2] (j = j1*n2 + j2). With
k = k1 + n1*k2:

  steps 1+2: column DFTs of size n1 over this rank's [n1, n2/D] columns,
             times w^(k1*j2) (local)
  step 3:    all_to_all_tiled [n1, n2/D] -> [n1/D, n2] (the only exchange)
  step 4:    row DFTs of size n2, n^-1 folded in for the inverse (local)

The output is Y[k1, k2] sharded over k1; the natural-order result vector is
transpose(Y).reshape(n). Bit-identical to the single-card NTT.

Where the JAX package runs its local butterflies as plain XLA stages, the
port runs them on its phase kernels (ops/ntt_torch.ntt_axis0 / ntt_axis1:
K2, and K3 above 2^max_phase_log2 points a side). The step-2 twiddle is
fused into the last column phase from this rank's slice of the four-step
table, built on the device from two small power tables (no n-entry table).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops import goldilocks as G
from ..ops import ntt_torch as NT
from .mesh import Mesh, all_to_all_tiled, make_global, replicated_pull


def build_sharded_ntt(mesh: Mesh, n1_log2: int, n2_log2: int, inverse: bool = False,
                      max_phase_log2: int = NT.MAX_PHASE_LOG2):
    """A sharded NTT of size n = 2^(n1_log2 + n2_log2).

    Returns f(a, timings=None) mapping this rank's A[n1, n2/D] columns (int64
    field tensor on mesh.device) to its rows Y[n1/D, n2] with
    Y[k1, k2] = y_{k1 + n1*k2}; `timings`, a dict, receives the seconds of the
    all-to-all ("all_to_all", device synchronised around it)."""
    n1, n2 = 1 << n1_log2, 1 << n2_log2
    d = mesh.size
    if n1 % d or n2 % d:
        raise ValueError("n1 and n2 must be divisible by the world's size")
    n_log2 = n1_log2 + n2_log2
    n2loc = n2 // d
    col0 = mesh.rank * n2loc
    scale = G.inv(1 << n_log2) if inverse else 1

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    def f(a: torch.Tensor, timings: Optional[dict] = None) -> torch.Tensor:
        if tuple(a.shape) != (n1, n2loc):
            raise ValueError(f"this rank's input is [{n1}, {n2loc}], not {tuple(a.shape)}")
        z = NT.ntt_axis0(a, inverse, n_log2=n_log2, col0=col0, max_phase_log2=max_phase_log2)
        if timings is not None:
            sync()
            t0 = time.perf_counter()
        y = all_to_all_tiled(z, mesh, 0, 1)
        if timings is not None:
            sync()
            timings["all_to_all"] = timings.get("all_to_all", 0.0) + time.perf_counter() - t0
        return NT.ntt_axis1(y, inverse, scale=scale, max_phase_log2=max_phase_log2)

    return f


def sharded_ntt_u64(a: np.ndarray, mesh: Mesh, n1_log2: Optional[int] = None, inverse: bool = False,
                    max_phase_log2: int = NT.MAX_PHASE_LOG2) -> np.ndarray:
    """Host convenience: natural-order u64 in (the same on every rank),
    natural-order u64 out (on every rank)."""
    n = a.shape[0]
    n_log2 = n.bit_length() - 1
    assert 1 << n_log2 == n
    if n1_log2 is None:
        n1_log2 = n_log2 // 2
    n2_log2 = n_log2 - n1_log2
    n1, n2 = 1 << n1_log2, 1 << n2_log2
    f = build_sharded_ntt(mesh, n1_log2, n2_log2, inverse, max_phase_log2)
    x = make_global(mesh, 1, np.asarray(a, dtype=np.uint64).reshape(n1, n2))
    y = replicated_pull(mesh, f(x), 0)  # Y[k1, k2]
    return np.ascontiguousarray(y.T).reshape(n)  # k = k1 + n1*k2
