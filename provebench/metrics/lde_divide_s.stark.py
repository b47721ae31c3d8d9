"""Seconds a prove spends in the DEEP divide: the program's span
`lde.divide` (ops/ntt_torch.deep_coset_lde), the inversion of x - z over the
LDE domain (`pow_p_minus_2`) and its multiply, synchronised at its end, so
its device time. A mean over the proves whose span began in the window;
None where the program records no spans, where its recorder dropped one of
theirs, or without a device trace."""


def read(run):
    from sezkp_tpu_torch.utils import tracing

    recorder = getattr(tracing, "RECORDER", None)
    if recorder is None or not run.device_events:
        return None
    spans = recorder.proves(run.window_start, run.window_end)
    divides = [s.end - s.begin for s in spans or () if s.name == "lde.divide"]
    if not divides:
        return None
    return sum(divides) / sum(1 for s in spans if s.parent < 0)
