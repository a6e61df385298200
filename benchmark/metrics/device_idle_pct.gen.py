"""Share of the traced window in which no kernel, copy or memset ran on
the device: the profiler's device intervals merged (``device_trace``)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
