"""Seconds a prove spends committing the columns and opening the AIR rows
(stages commit + air_openings)."""

import window


def read(run):
    return window.mean_stage(run.proves, "commit", "air_openings")
