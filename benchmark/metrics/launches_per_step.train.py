"""launches_per_step.train: Device events (kernels, memsets, copies) in the
traced stretches per `Trainer.step` the driver ran in them."""

from harness.readers import events_per_unit as read  # noqa: F401
