"""Plotting helpers of the port (matplotlib is not imported here)."""

from nr3d_lib_tpu_torch.plot.plot_basic import gallery  # noqa: F401
