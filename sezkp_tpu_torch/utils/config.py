"""Configuration plumbing (reference aux subsystem, SURVEY.md section 5.6).

Three mechanisms, mirroring the reference:
  (a) CLI flags (sezkp_tpu_torch/cli.py)
  (b) env vars: SEZKP_FOLD_MODE, SEZKP_FOLD_CACHE, SEZKP_WRAP_CADENCE,
      SEZKP_PROOF_STREAM_PATH (fold/backend.py)
  (c) TOML profiles for the bench harness (benchmarks/profiles/*.toml)

This module centralizes the env keys and TOML profile loading. There is no
compile cache to enable: the CUDA kernels' build directory
(sezkp_tpu_torch/_build/) is the cache.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass

ENV_KEYS = {
    "FOLD_MODE": "SEZKP_FOLD_MODE",
    "FOLD_CACHE": "SEZKP_FOLD_CACHE",
    "WRAP_CADENCE": "SEZKP_WRAP_CADENCE",
    "PROOF_STREAM_PATH": "SEZKP_PROOF_STREAM_PATH",
    "LOG": "SEZKP_LOG",
}


@dataclass
class BenchProfile:
    t: int
    b: int
    tau: int
    repeats: int


def load_profile(path: str) -> BenchProfile:
    with open(path, "rb") as f:
        d = tomllib.load(f)
    return BenchProfile(t=d["t"], b=d["b"], tau=d["tau"], repeats=d["repeats"])


def env(key: str, default: str | None = None) -> str | None:
    return os.environ.get(ENV_KEYS.get(key, key), default)
