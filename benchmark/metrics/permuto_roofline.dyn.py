"""permuto_roofline.dyn: Percent: the least time of the 4D lattice's
encodes, their backwards and the nablas that the traced steps need
(counted from the calls' rows, `harness/permuto_work.py`) over the
device time of the kernels named below (B14, B15, B16). The nablas'
backward runs as plain PyTorch, not in these kernels, and is left out
of both."""

from harness.permuto_work import kernel_roofline

KERNELS = r"^(void )?permuto4_"


def read(ctx):
    return kernel_roofline(ctx, KERNELS, ("fwd", "bwd", "dydx"))
