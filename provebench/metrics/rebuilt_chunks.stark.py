"""Chunk trees a prove rebuilds at opening time: the program's counter
`openings.rebuilt_chunks` (utils/tracing.count), the distinct (column,
chunk) trees of the AIR openings without resident leaf CVs and the distinct
(FRI layer, chunk) trees of the chunked FRI's openings. A mean over the
proves whose span began in the window; None where the program keeps no such
counter, where its recorder dropped an entry of theirs, or without a device
trace."""

NAMES = ("openings.rebuilt_chunks",)


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
