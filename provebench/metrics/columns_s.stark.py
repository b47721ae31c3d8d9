"""Seconds a prove spends deriving and composing the columns (device route:
device_columns + device_compose; host route: host_columns + host_compose)."""

import window


def read(run):
    return window.mean_stage(run.proves, "device_columns", "device_compose",
                             "host_columns", "host_compose")
