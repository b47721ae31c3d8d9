"""Seconds a prove spends rebuilding at opening time what the memory bound
dropped: the program's spans `air_openings.recompute` (the queried column
chunks derived anew and their trees rebuilt, ending with the pull of their
paths) and `fri_openings.rehash` (the queried FRI chunks' trees rebuilt,
synchronised at its end while recorded), so their device time. A mean over
the proves whose span began in the window; None where the program records
no such span, where its recorder dropped one of theirs, or without a device
trace."""

NAMES = ("air_openings.recompute", "fri_openings.rehash")


def read(run):
    from sezkp_tpu_torch.utils import tracing

    recorder = getattr(tracing, "RECORDER", None)
    if recorder is None or not run.device_events:
        return None
    spans = recorder.proves(run.window_start, run.window_end)
    spent = [s.end - s.begin for s in spans or () if s.name in NAMES]
    if not spent:
        return None
    return sum(spent) / sum(1 for s in spans if s.parent < 0)
