"""samples_per_ray.train: Points the field encoded per trained ray in the
traced window: the rows of every call of the configured encodings, over
the steps' rays (the occupancy updates' points included)."""

from harness.readers import samples_per_ray as read  # noqa: F401
