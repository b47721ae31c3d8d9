"""Collective-traffic accounting for the sharded prover.

Counterpart of sezkp_tpu/parallel/traffic.py. Two views:

- `collective_bytes(mesh, scope=None)`: what this rank's collectives moved,
  read from the mesh's tally (parallel/mesh.py counts every all-to-all,
  all-gather and ppermute of a world of more than one as it runs): per
  kind, the calls, the bytes of their outputs on this rank and the bytes
  this rank sent to other ranks. It stands where the JAX package parses the
  compiled XLA module (`collective_bytes_from_hlo`), which the port never
  produces.
- `analytic_phase_bytes` and `scaling_model`: copied from the JAX package
  (closed-form per-device byte volumes of phases 1 and 2 as a function of
  (base_log2, blow_log2, D), and the scaling model built on them), with the
  import re-pointed. `ShardedPipeline` follows the JAX collective schedule,
  so its tally meets the model term for term; the two places where they
  differ (the halo term, the fold's ppermutes that stay on a rank) are
  stated in tests/test_torch_parallel_full.py.
"""

from __future__ import annotations

from typing import Dict, Optional


def collective_bytes(mesh, scope: Optional[str] = None) -> Dict[str, dict]:
    """This rank's collectives from the tally of `mesh` (those of `scope`,
    or every scope): {kind: {"count", "bytes", "link_bytes"}}, kinds
    "all-to-all", "all-gather", "collective-permute". "bytes" is the output
    of the calls on this rank (JAX's per-device payload), "link_bytes" what
    this rank sent to other ranks. The sharded prover's scopes are
    "phase1", "phase2" and "open"."""
    out: Dict[str, dict] = {}
    for (sc, op), rec in mesh.tally.records.items():
        if scope is not None and sc != scope:
            continue
        acc = out.setdefault(op, {"count": 0, "bytes": 0, "link_bytes": 0})
        for k in acc:
            acc[k] += rec[k]
    return out


def analytic_phase_bytes(base_log2: int, blow_log2: int, d: int,
                         tau: int = 8) -> Dict[str, float]:
    """Per-device ICI byte volumes for one sharded prove (both phases).

    Every field element moves as two u32 planes (8 B). Formulas follow
    parallel/prove_sharded.py's collectives one-for-one:

    phase 1 (per device, payload bytes; multiply by (D-1)/D for link):
      halo ppermute      : 2 slabs x tau rows x 1 col x 8 B       (tiny)
      intt input a2a     : n/D x 8
      intt internal a2a  : n/D x 8
      coeff relayout a2a : 2 x n/D x 8
      lde internal a2a   : ln/D x 8
      natural order a2a  : ln/D x 8
      roots all_gather   : 32 x D                                  (tiny)
    phase 2:
      fold ppermutes     : sum over device layers of (m_l/D) x 8
                           (the four half-shard ppermutes move each
                           device's full local layer once)
      tail all_gather    : 2^MIN_DEVICE_LAYER_LOG2 x 8 x (D-1)/D
      roots all_gather   : 32 x L x D                              (tiny)
    """
    from .prove_sharded import MIN_DEVICE_LAYER_LOG2

    n = 1 << base_log2
    ln = 1 << (base_log2 + blow_log2)
    b = 8.0
    frac = (d - 1) / d if d > 1 else 0.0

    phase1 = {
        "halo_ppermute": 2 * 2 * tau * b,
        "intt_input_a2a": (n / d) * b * frac,
        "intt_internal_a2a": (n / d) * b * frac,
        "coeff_relayout_a2a": 2 * (n / d) * b * frac,
        "lde_internal_a2a": (ln / d) * b * frac,
        "natural_order_a2a": (ln / d) * b * frac,
        "roots_all_gather": 32.0 * d * frac,
    }
    dev_layers = max(1, (base_log2 + blow_log2) - MIN_DEVICE_LAYER_LOG2)
    fold = 0.0
    m = ln
    for _ in range(dev_layers):
        fold += (m / d) * b  # ppermute: full local layer crosses once
        m //= 2
    phase2 = {
        "fold_ppermutes": fold,
        "tail_all_gather": float(1 << MIN_DEVICE_LAYER_LOG2) * b * frac,
        "roots_all_gather": 32.0 * dev_layers * d * frac,
    }
    total = sum(phase1.values()) + sum(phase2.values())
    return {"phase1": phase1, "phase2": phase2, "total_per_device": total}


def scaling_model(base_log2: int, blow_log2: int, d: int,
                  single_chip_seconds: float,
                  ici_bytes_per_s: float = 200e9, tau: int = 8,
                  host_seconds: float = 0.0) -> dict:
    """Predicted scaling efficiency 1 -> D chips.

    t_D = t_1_dev/D + traffic_D / ICI_BW + t_host (serial, pessimistic) and
    max(t_1_dev/D, traffic) + t_host (overlapped); efficiency is
    t_1 / (D * t_D) where t_1 = t_1_dev + t_host. v5e ICI: 4 links x
    400 Gb/s ~ 200 GB/s per chip usable (public spec).

    `host_seconds` is the measured host-serialized transcript time (root
    pulls, Fiat-Shamir, query planning, proof assembly) — it does NOT
    shrink with D, so it is the real Amdahl term that bounds efficiency at
    t_dev/(t_dev + t_host) as D grows (SCALING.md caveat 2, VERDICT
    round-3 item 6). `single_chip_seconds` here is the DEVICE portion of
    the single-chip prove (total minus host_seconds)."""
    tr = analytic_phase_bytes(base_log2, blow_log2, d, tau)
    t_ici = tr["total_per_device"] / ici_bytes_per_s
    t_comp = single_chip_seconds / d
    t_serial = t_comp + t_ici + host_seconds
    t_overlap = max(t_comp, t_ici) + host_seconds
    t_1 = single_chip_seconds + host_seconds
    return {
        "d": d,
        "traffic_per_device_bytes": tr["total_per_device"],
        "t_compute_s": t_comp,
        "t_ici_s": t_ici,
        "t_host_s": host_seconds,
        "efficiency_serial": t_1 / (d * t_serial),
        "efficiency_overlapped": t_1 / (d * t_overlap),
    }
