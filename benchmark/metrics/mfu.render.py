"""mfu.render: Percent of the H100's float32 peak (67 TFLOP/s) that the
operations the traced frames need take of their wall time at the pace of
the run's untraced frames: every Linear layer's 2*in*out a row, the
nablas' decoder pass where the model has one, and the encoding's own
operations."""

from harness.readers import mfu as read  # noqa: F401
