"""Math utilities of the port (rotation conversions)."""

from nr3d_lib_tpu_torch.maths.transforms import quaternion_to_matrix  # noqa: F401
