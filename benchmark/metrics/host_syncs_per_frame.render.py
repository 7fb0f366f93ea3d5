"""host_syncs_per_frame.render: Host waits for the device a frame: the
`syncs` counter of every span of the frame, the median over the frames
the program's span ring holds."""

from harness.spans import median_per_unit, syncs


def read(ctx):
    return median_per_unit("frame", syncs)
