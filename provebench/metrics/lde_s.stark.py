"""Seconds a prove spends in the DEEP coset LDE (stage lde)."""

import window


def read(run):
    return window.mean_stage(run.proves, "lde")
