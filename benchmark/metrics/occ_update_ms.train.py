"""occ_update_ms.train: Host ms of one `occ.update` span (the occupancy
grid's EMA re-query, every 16 steps), the median over the updates inside
the steps the program's span ring holds."""

from harness.spans import span_ms

SPAN = "occ.update"


def read(ctx):
    return span_ms("step", SPAN)
