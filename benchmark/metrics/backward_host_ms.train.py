"""backward_host_ms.train: Host ms a training step spends in its
`step.backward` span (`loss.backward()`: the autograd graph's launches
and the waits inside it), the median over the steps the program's span
ring holds."""

from harness.spans import host_ms, median_per_unit

SPANS = ("step.backward",)


def read(ctx):
    return median_per_unit("step", host_ms(SPANS))
