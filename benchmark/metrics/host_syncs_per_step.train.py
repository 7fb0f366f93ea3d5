"""host_syncs_per_step.train: Host waits for the device a training step:
the `syncs` counter of every span of the step, the median over the steps
the program's span ring holds."""

from harness.spans import median_per_unit, syncs


def read(ctx):
    return median_per_unit("step", syncs)
