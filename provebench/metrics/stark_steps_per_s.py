"""Trace steps of all STARK proves completed in the window over its length."""

import window


def read(run):
    return window.rate(run.proves, run.window_s) if run.proves else None
