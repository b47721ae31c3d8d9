"""The device's timeline over the traced window, from `torch.profiler`.

Only device activity is recorded (kernels, copies, fills): the host side
is timed by the prover's own `timings` and by the harness. The profiler's
clock is tied to the host's by a marker kernel (`torch.cuda._sleep`)
launched at a known host time, once at the start and once at the end of the
window; the two must agree to well under a stage's length.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import window

MARKER = "spin_kernel"

DeviceEvent = Tuple[str, float, float]


def _ns(e, which: str) -> int:
    if hasattr(e, f"{which}_ns"):
        return getattr(e, f"{which}_ns")()
    return int(getattr(e, f"{which}_us")() * 1000)


class DeviceTrace:
    """Context manager around the window. After it closes, `events` are
    (name, begin, end) of every device operation in host-clock seconds, or
    None when the profiler recorded no device activity."""

    def __init__(self):
        self.events: Optional[List[DeviceEvent]] = None
        self.clock_skew_s: Optional[float] = None
        self.parse_s = 0.0

    @staticmethod
    def _mark() -> float:
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        return t

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t_first = self._mark()
        return self

    def __exit__(self, *exc):
        self._t_last = self._mark()
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._read()
        self.parse_s = time.perf_counter() - t0
        return False

    def _read(self) -> Optional[List[DeviceEvent]]:
        from torch.autograd import DeviceType

        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            begin = _ns(e, "start")
            raw.append((e.name(), begin, begin + _ns(e, "duration")))
        marks = sorted(b for n, b, _ in raw if MARKER in n)
        if len(marks) < 2:
            return None
        offset = marks[0] * 1e-9 - self._t_first
        self.clock_skew_s = (marks[-1] * 1e-9 - offset) - self._t_last
        return [(n, b * 1e-9 - offset, e * 1e-9 - offset) for n, b, e in raw if MARKER not in n]


def is_kernel(name: str) -> bool:
    """A kernel launch, as opposed to a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def idle_share(run):
    """Per cent of the window with no device operation running."""
    if not run.device_events or not run.window_s > 0:
        return None
    busy = window.busy([(b, e) for _, b, e in run.device_events], run.window_start, run.window_end)
    return 100.0 * (1.0 - busy / run.window_s)


def launches_per_prove(run):
    """Kernel launches (torch's and the hand-written ones) a prove."""
    if not run.device_events or not run.proves:
        return None
    n = sum(1 for name, b, _ in run.device_events
            if is_kernel(name) and run.window_start <= b < run.window_end)
    return n / len(run.proves)
