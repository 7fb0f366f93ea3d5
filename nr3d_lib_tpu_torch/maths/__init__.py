"""Math utilities of the port (port of nr3d_lib_tpu/maths/)."""

from nr3d_lib_tpu_torch.maths.transforms import (  # noqa: F401
    quaternion_to_matrix, matrix_to_quaternion, axis_angle_to_matrix,
    matrix_to_axis_angle, axis_angle_to_quaternion, quaternion_to_axis_angle,
    rotation_6d_to_matrix, matrix_to_rotation_6d, quaternion_multiply,
    quaternion_invert, quaternion_apply)
from nr3d_lib_tpu_torch.maths.slerp import slerp  # noqa: F401
from nr3d_lib_tpu_torch.maths.common import (  # noqa: F401
    logistic_density, logistic_cdf, normalize)
from nr3d_lib_tpu_torch.maths.knn import (  # noqa: F401
    knn_points, knn_gather, chamfer_distance, dist_to_nn3_mean)
from nr3d_lib_tpu_torch.maths.depth_completion import \
    depth_completion  # noqa: F401
