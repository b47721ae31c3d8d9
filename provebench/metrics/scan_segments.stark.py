"""Segments a prove runs to bound its device memory, each a train of
launches: the program's counters (utils/tracing.count) `commit.scan_segments`
(the roots-only column commitments, 2^21 rows of a column a segment),
`compose.slabs` (the composition, 2^19 rows a slab) and
`fri.chunk_tops_segments` (the chunked FRI's layer hashing, 2^21 leaves a
segment). A mean over the proves whose span began in the window; None where
the program keeps none of these counters, where its recorder dropped an
entry of theirs, or without a device trace."""

NAMES = ("commit.scan_segments", "compose.slabs", "fri.chunk_tops_segments")


def read(run):
    from sezkp_tpu_torch.utils import tracing

    recorder = getattr(tracing, "RECORDER", None)
    counters = getattr(tracing, "counters", None)
    if recorder is None or counters is None or not run.device_events:
        return None
    spans = recorder.proves(run.window_start, run.window_end)
    totals = counters(spans or ())
    if not any(name in totals for name in NAMES):
        return None
    return sum(totals.get(name, 0) for name in NAMES) / sum(1 for s in spans if s.parent < 0)
