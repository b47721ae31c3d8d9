"""The port's span recorder, the operator's log lines, and the profiler hook.

Spans (reference aux subsystem: tracing/tracing-subscriber in sezkp-cli,
SURVEY.md section 5.1). A span is a name, a kind, a begin and an end on
``time.perf_counter`` (the clock a device trace is mapped onto), its parent
span and the id of the prove it belongs to. Spans are recorded only while a
prove runs with a `timings` dict (``proving``, ``records``); elsewhere
``span`` returns one shared no-op context manager: no clock read, no sync,
no string, no allocation. Recorded spans go to a bounded ring
(``Recorder``, 2^16 spans), which counts what it drops; readers read them
after the run (``RECORDER.proves``, ``cover``, ``counters``).

Counters (``count``): integers a prove adds up while it runs (segments a
scan ran, chunk trees an opening rebuilt, bytes released). They are kept in
the open prove's record, with no clock read and no sync, and go to the ring
when the prove closes, one entry of kind ``count`` a name (a zero-length
span holding the total in ``value``), so the ring drops them as it drops
spans. Outside a recorded prove ``count`` does nothing.

Kinds say what the host does inside a span:

- ``host``: computes or copies host memory, and enqueues no device work;
- ``launch``: enqueues device work and waits for none of it;
- ``wait``: waits on the device (a device->host copy, a synchronize, an
  upload from pageable memory, which torch synchronises).

The stages of a prove (``Stages``) are spans under the prove's own span;
their time outside their sub-spans is mostly the sync at their edge, so
they are of kind ``wait`` unless marked otherwise.

Env: SEZKP_LOG / RUST_LOG = debug|info|warning|error (default info).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import contextvars
import functools
import itertools
import logging
import os
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

log = logging.getLogger("sezkp_tpu_torch")

HOST, LAUNCH, WAIT = "host", "launch", "wait"
COUNT = "count"
RING = 1 << 16

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


class Span(NamedTuple):
    """One closed span. `parent` and `seq` are sequence numbers of the
    recorder (-1: no parent); `prove` is the id of the prove it belongs to.
    A counter's entry is of kind COUNT, begins and ends when its prove
    closes, lies under the prove's span and holds its total in `value`."""

    name: str
    kind: str
    begin: float
    end: float
    parent: int
    prove: int
    seq: int
    value: int = 0


class Recorder:
    """A ring of the last `capacity` closed spans. `dropped` counts the spans
    the ring let go, `dropped_prove` is the newest prove id among them."""

    def __init__(self, capacity: int = RING):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = itertools.count()
        self._prove = itertools.count()
        self.dropped = 0
        self.dropped_prove = -1

    def add(self, span: Span) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
            self.dropped_prove = max(self.dropped_prove, self._ring[0].prove)
        self._ring.append(span)

    def spans(self) -> List[Span]:
        return list(self._ring)

    def proves(self, lo: float, hi: float) -> Optional[List[Span]]:
        """The spans of every prove whose own span began in [lo, hi), or None
        when the ring dropped a span of one of them."""
        ids = {s.prove for s in self._ring if s.parent < 0 and lo <= s.begin < hi}
        if ids and min(ids) <= self.dropped_prove:
            return None
        return [s for s in self._ring if s.prove in ids]


RECORDER = Recorder()


class _Open:
    """An open span (a prove's has no name): what its children take (the
    recorder, the prove id, `under`: the parent they record) and what it
    records when it closes."""

    __slots__ = ("rec", "prove", "under", "seq", "parent", "name", "kind", "sync", "begin",
                 "token", "counts")


# the innermost open span of this context, None when nothing is recorded
_CURRENT: contextvars.ContextVar[Optional[_Open]] = contextvars.ContextVar(
    "sezkp_tracing_current", default=None)
_NOOP = contextlib.nullcontext()


def _sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Span(_Open):
    __slots__ = ()

    def __init__(self, cur: _Open, name: str, kind: str, sync: bool):
        self.rec, self.prove, self.parent, self.counts = cur.rec, cur.prove, cur.under, cur.counts
        self.name, self.kind, self.sync = name, kind, sync

    def __enter__(self):
        self.seq = self.under = next(self.rec._seq)
        self.token = _CURRENT.set(self)
        self.begin = time.perf_counter()

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        end = time.perf_counter()
        _CURRENT.reset(self.token)
        self.rec.add(Span(self.name, self.kind, self.begin, end, self.parent, self.prove, self.seq))
        return False


def span(name: str, kind: str = HOST, sync: bool = False):
    """A span of the running prove; the shared no-op outside one. `sync`
    synchronises the card at its end, so that the span is charged the device
    work it queued (only while recording)."""
    cur = _CURRENT.get()
    if cur is None:
        return _NOOP
    return _Span(cur, name, kind, sync)


def count(name: str, n: int) -> None:
    """Add `n` to the running prove's counter `name`; nothing outside one."""
    cur = _CURRENT.get()
    if cur is not None:
        cur.counts[name] = cur.counts.get(name, 0) + n


@contextlib.contextmanager
def proving(timings: Optional[dict], recorder: Optional[Recorder] = None) -> Iterator[None]:
    """Record the spans of one prove, under a top-level span `prove`, when
    `timings` is a dict and no prove is being recorded in this context."""
    if timings is None or _CURRENT.get() is not None:
        yield
        return
    rec = RECORDER if recorder is None else recorder
    top = _Open()
    top.rec, top.prove, top.seq, top.name = rec, next(rec._prove), next(rec._seq), None
    top.under, top.counts = top.seq, {}
    token = _CURRENT.set(top)
    begin = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        _CURRENT.reset(token)
        for name, n in top.counts.items():
            rec.add(Span(name, COUNT, end, end, top.seq, top.prove, next(rec._seq), n))
        rec.add(Span("prove", HOST, begin, end, -1, top.prove, top.seq))


def records(fn: Callable) -> Callable:
    """Decorate a prove function whose keyword `timings` switches recording:
    its call is one recorded prove when `timings` is a dict."""

    @functools.wraps(fn)
    def wrapped(*args, timings: Optional[dict] = None, **kwargs):
        if timings is None:
            return fn(*args, **kwargs)
        with proving(timings):
            return fn(*args, timings=timings, **kwargs)

    return wrapped


class Stages:
    """Consecutive stages of a prove: `mark(name)` ends the running stage,
    adds its wall seconds to `out[name]` and begins the next. Inactive
    without a dict. On the card it synchronises at every edge, so that a
    stage is charged the device work it queued. While the prove is recorded
    each stage is a span under the prove's, and the spans opened during a
    stage are its children."""

    def __init__(self, out: Optional[dict], device):
        self.out = out
        self.cuda = device is not None and device.type == "cuda"
        cur = _CURRENT.get()
        self._top = cur if out is not None and cur is not None and cur.name is None else None
        if self._top is not None:
            self._top.under = next(self._top.rec._seq)
        self.t = time.perf_counter() if out is not None else 0.0

    def mark(self, name: str, kind: str = WAIT) -> None:
        if self.out is None:
            return
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + (now - self.t)
        top = self._top
        if top is not None:
            top.rec.add(Span(name, kind, self.t, now, top.seq, top.prove, top.under))
            top.under = next(top.rec._seq)
        self.t = now


# ---------------------------- reading the spans -----------------------------


def counters(spans: Sequence[Span]) -> Dict[str, int]:
    """The counters' totals over `spans` (every prove among them)."""
    out: Dict[str, int] = {}
    for s in spans:
        if s.kind == COUNT:
            out[s.name] = out.get(s.name, 0) + s.value
    return out


def cover(spans: Sequence[Span], intervals: Sequence[Tuple[float, float]],
          key: Callable[[Span], str] = lambda s: s.kind) -> Dict[str, float]:
    """Seconds of the sorted, disjoint `intervals` (device gaps, say) by
    `key` of the innermost span open over them; parts under no span are
    left out. The spans nest (each lies inside its parent, siblings apart)."""
    depth: Dict[int, int] = {}
    by_seq = {s.seq: s for s in spans}

    def depth_of(s: Span) -> int:
        d = depth.get(s.seq)
        if d is None:
            p = by_seq.get(s.parent)
            d = depth[s.seq] = 0 if p is None else depth_of(p) + 1
        return d

    # at one instant ends come before begins, inner ends and outer begins first
    events = []
    for s in spans:
        if s.end > s.begin:
            d = depth_of(s)
            events.append((s.begin, 1, d, s.seq))
            events.append((s.end, 0, -d, s.seq))
    events.sort()
    # the innermost open span between consecutive event times
    segments: List[Tuple[float, float, Span]] = []
    stack: List[int] = []
    for (t, begins, _, seq), nxt in zip(events, events[1:] + [None]):
        if begins:
            stack.append(seq)
        else:
            stack.remove(seq)
        if stack and nxt is not None and nxt[0] > t:
            segments.append((t, nxt[0], by_seq[stack[-1]]))
    out: Dict[str, float] = {}
    starts = [a for a, _, _ in segments]
    for g0, g1 in intervals:
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segments) and segments[i][0] < g1:
            a, b, s = segments[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                k = key(s)
                out[k] = out.get(k, 0.0) + part
            i += 1
    return out


# ----------------------------- the operator's log ----------------------------


@contextlib.contextmanager
def command(name: str, **fields) -> Iterator[None]:
    """A CLI command: its INFO line with its wall time (the operator's view),
    a DEBUG line on entry, and a span while a prove is recorded."""
    init_tracing()
    extra = " ".join(f"{k}={v}" for k, v in fields.items()) if log.isEnabledFor(logging.INFO) else ""
    if log.isEnabledFor(logging.DEBUG):
        log.debug("enter %s %s", name, extra)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        log.info("%s %s took %.1f ms", name, extra, (time.perf_counter() - t0) * 1e3)


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
