"""kept_share.train: Percent of the final sample slots that hold a sample
after the compaction: 100 * sum(kept) / sum(slots) over the `query`
spans inside the steps the program's span ring holds."""

from harness.spans import kept_share


def read(ctx):
    return kept_share("step")
