"""optimizer_ms.train: Host ms a training step spends in its `step.clip`
and `step.optimizer` spans (the global-norm clip and Adam), the median
over the steps the program's span ring holds."""

from harness.spans import host_ms, median_per_unit

SPANS = ("step.clip", "step.optimizer")


def read(ctx):
    return median_per_unit("step", host_ms(SPANS))
