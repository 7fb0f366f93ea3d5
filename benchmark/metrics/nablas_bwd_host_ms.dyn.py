"""nablas_bwd_host_ms.dyn: Host ms a training step spends in its
`enc.nablas_bwd` spans (the 4D lattice's nablas backward, the eikonal
loss's second order, as plain PyTorch on autograd's thread), the median
over the steps the program's span ring holds; None where no step holds
such a span."""

from harness.spans import host_ms, median_per_unit, span_ms

SPAN = "enc.nablas_bwd"


def read(ctx):
    if span_ms("step", SPAN) is None:
        return None
    return median_per_unit("step", host_ms((SPAN,)))
