"""Device-idle seconds a prove while the host computes: the gaps between
the profiler's device intervals over the window that fall where the
innermost open program span (utils/tracing.py) is of kind `host`. A mean
over the proves whose span began in the window; None where the program
records no spans, where its recorder dropped one of theirs, or without a
device trace."""

import window


def read(run):
    from sezkp_tpu_torch.utils import tracing

    recorder = getattr(tracing, "RECORDER", None)
    if recorder is None or not run.device_events:
        return None
    spans = recorder.proves(run.window_start, run.window_end)
    if not spans:
        return None
    gaps = window.gaps([(b, e) for _, b, e in run.device_events], run.window_start, run.window_end)
    idle = tracing.cover(spans, gaps)
    return idle.get(tracing.HOST, 0.0) / sum(1 for s in spans if s.parent < 0)
