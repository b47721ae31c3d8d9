"""Device kernels a prove, torch's and the hand-written ones, from the
profiler over the window."""

from profiling import launches_per_prove as read  # noqa: F401
