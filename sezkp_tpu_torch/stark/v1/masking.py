"""Transcript-derived ZK masking polynomials (reference: v1/masking.rs).

Draw schedule is part of the wire contract: absorb("masks", b"masks"),
absorb_u64("n_masks", k), absorb_u64("deg", deg), then k*deg 8-byte
challenges under "mask_coeff".
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from ...crypto.transcript import Blake3Transcript
from ...ops import goldilocks as G

DS_MASKS = "masks"
DEFAULT_N_MASKS = 1
DEFAULT_MASK_DEG = 4


def derive_mask_coeffs(
    tr: Blake3Transcript, deg: int = DEFAULT_MASK_DEG, k: int = DEFAULT_N_MASKS
) -> List[List[int]]:
    tr.absorb(DS_MASKS, DS_MASKS.encode())
    tr.absorb_u64("n_masks", k)
    tr.absorb_u64("deg", deg)
    out = []
    for _ in range(k):
        coeffs = []
        for _ in range(deg):
            b = tr.challenge_bytes("mask_coeff", 8)
            coeffs.append(struct.unpack("<Q", b)[0] % int(G.P))
        out.append(coeffs)
    return out


def eval_masks_sum_at_points(all_coeffs: List[List[int]], xs: np.ndarray) -> np.ndarray:
    """Sum of Horner evaluations of each mask at every point in xs (vectorized)."""
    xs = np.asarray(xs, dtype=np.uint64)
    total = np.zeros_like(xs)
    for coeffs in all_coeffs:
        acc = np.zeros_like(xs)
        for c in reversed(coeffs):
            acc = G.add(G.mul(acc, xs), np.uint64(c))
        total = G.add(total, acc)
    return total
