"""to_host_ms.render: Host ms a frame spends in its `frame.to_host` spans
(the outputs to numpy, which wait for the device) and `frame.assemble`
(concatenate and reshape), the median over the frames the program's span
ring holds."""

from harness.spans import host_ms, median_per_unit

SPANS = ("frame.to_host", "frame.assemble")


def read(ctx):
    return median_per_unit("frame", host_ms(SPANS))
