"""torch.cuda.max_memory_allocated() over the window (reset after set-up),
in 10^9 bytes."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
