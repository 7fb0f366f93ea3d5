"""kept_share.render: Percent of the final sample slots that hold a sample
after the compactions: 100 * sum(kept) / sum(slots) over the `query`
spans inside the frames the program's span ring holds."""

from harness.spans import kept_share


def read(ctx):
    return kept_share("frame")
