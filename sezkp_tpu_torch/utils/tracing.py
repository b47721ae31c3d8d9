"""Lightweight tracing spans (reference aux subsystem: tracing/tracing-subscriber
in sezkp-cli, SURVEY.md section 5.1) plus per-stage timers for the harness.

Env: SEZKP_LOG / RUST_LOG = debug|info|warning|error (default info).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, List, Tuple

log = logging.getLogger("sezkp_tpu_torch")

_initialized = False


def init_tracing() -> None:
    global _initialized
    if _initialized:
        return
    level = os.environ.get("SEZKP_LOG", os.environ.get("RUST_LOG", "info")).upper()
    if level not in ("DEBUG", "INFO", "WARNING", "ERROR"):
        level = "INFO"
    logging.basicConfig(
        level=getattr(logging, level),
        format="%(asctime)s %(levelname)s %(message)s",
        datefmt="%H:%M:%S",
    )
    _initialized = True


class SpanTimings:
    """Collects (name, ms) rows; the harness dumps them as CSV."""

    def __init__(self) -> None:
        self.rows: List[Tuple[str, float]] = []

    def add(self, name: str, ms: float) -> None:
        self.rows.append((name, ms))


_GLOBAL = SpanTimings()


@contextlib.contextmanager
def span(name: str, timings: SpanTimings | None = None, **fields) -> Iterator[None]:
    init_tracing()
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    log.debug("enter %s %s", name, extra)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        (timings or _GLOBAL).add(name, ms)
        log.info("%s %s took %.1f ms", name, extra, ms)


def global_timings() -> SpanTimings:
    return _GLOBAL


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace (CPU and CUDA activities) of the region
    and write it as a Chrome trace into `log_dir` (view with chrome://tracing
    or Perfetto). The profiler object is yielded, so the caller can read
    `key_averages()` after the region."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
