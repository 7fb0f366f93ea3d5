"""encode_roofline.train: Percent: the least time of the F=4 encoding work
the traced steps need (encodes, their backwards, the nablas and theirs,
counted from the calls' rows) over the device time of the kernels named
below."""

from harness.readers import encode_roofline

KERNELS = r"^(void )?brick4_"


def read(ctx):
    return encode_roofline(ctx, KERNELS)
