"""samples_per_ray.render: Points the field encoded per rendered ray
(pixel) in the traced window: the rows of every call of the configured
encodings."""

from harness.readers import samples_per_ray as read  # noqa: F401
