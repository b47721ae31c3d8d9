"""Seconds a prove spends in FRI: the commit, resident or chunked, and the
query openings."""

import window


def read(run):
    return window.mean_stage(run.proves, "fri_commit", "fri_commit_chunked", "fri_openings")
