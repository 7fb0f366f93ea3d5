"""query_host_ms.train: Host ms a training step spends in its `query` span
(the model's `ray_query`: march, compactions, upsample rounds, field
passes, composite), the median over the steps the program's span ring
holds."""

from harness.spans import host_ms, median_per_unit

SPANS = ("query",)


def read(ctx):
    return median_per_unit("step", host_ms(SPANS))
