"""The nearest-rank 90th percentile of the walls of all the window's proves,
each from its call until its proof bytes are on the host, synchronised."""

import window


def read(run):
    walls = [p["end"] - p["start"] for p in run.proves]
    return window.percentile(walls, 90) if walls else None
