"""encode_roofline.render: Percent: the least time of the F=4 encoding work
the traced frames need (encodes and nablas, counted from the calls'
rows) over the device time of the kernels named below."""

from harness.readers import encode_roofline

KERNELS = r"^(void )?brick4_"


def read(ctx):
    return encode_roofline(ctx, KERNELS)
