"""Per cent of the window in which no device operation runs: 1 - the union
of the profiler's device intervals over the window."""

from profiling import idle_share as read  # noqa: F401
