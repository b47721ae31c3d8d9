"""STARK v1 parameters, transcript labels, and challenge derivers.

Constants and derivation rules match crates/sezkp-stark/src/v1/params.rs
exactly (wire contract: the byte schedule of challenge draws IS the proof
format).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from ...crypto.transcript import Blake3Transcript
from ...ops import goldilocks as G

SOUNDNESS_BITS = 100
FRI_RATE = 2
BLOWUP = 8
NUM_QUERIES = 30
DOMAIN_MIN_LOG2 = 12
COL_CHUNK_LOG2 = 10  # 1024 rows per chunk
STREAM_CHUNK_LOG2 = 14

DS_V1_DOMAIN = "sezkp-stark/v1"
DS_N_COLS = "n_cols"
DS_COL_ROOT = "col_root"
DS_COL_LEAF = "col_leaf"
DS_ALPHAS = "alphas"
DS_QUERIES = "row_queries"
DS_FRI_BETAS = "fri_betas"
DS_FRI_LAYER_ROOT = "fri_layer_root"
DS_OOD_POINT = "ood_point"
DS_DEEP_ALPHA = "deep_alpha"

NUM_ALPHAS = 8


def _f_from_le8(b: bytes) -> int:
    return struct.unpack("<Q", b)[0] % int(G.P)


def derive_alphas(tr: Blake3Transcript) -> List[int]:
    data = tr.challenge_bytes(DS_ALPHAS, 8 * NUM_ALPHAS)
    return [_f_from_le8(data[8 * i : 8 * i + 8]) for i in range(NUM_ALPHAS)]


def derive_queries(tr: Blake3Transcript, n: int, k: int) -> List[int]:
    data = tr.challenge_bytes(DS_QUERIES, 8 * k)
    m = max(n, 1)
    return [struct.unpack("<Q", data[8 * i : 8 * i + 8])[0] % m for i in range(k)]


def derive_betas_for_fri(tr: Blake3Transcript, n_layers: int) -> List[int]:
    data = tr.challenge_bytes(DS_FRI_BETAS, 8 * n_layers)
    return [_f_from_le8(data[8 * i : 8 * i + 8]) for i in range(n_layers)]


def derive_ood_point(tr: Blake3Transcript) -> int:
    return _f_from_le8(tr.challenge_bytes(DS_OOD_POINT, 8))
