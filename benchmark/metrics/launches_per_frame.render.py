"""launches_per_frame.render: Device events (kernels, memsets, copies) in
the traced stretches per `NeuralRenderer.render` frame the driver ran in
them."""

from harness.readers import events_per_unit as read  # noqa: F401
