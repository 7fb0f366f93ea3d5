"""device_idle.render: Percent of the traced frames' wall time, at the
pace of the run's untraced frames, in which no kernel, memset or copy of
theirs ran on the device: 1 - the union of their intervals over it."""

from harness.readers import device_idle as read  # noqa: F401
