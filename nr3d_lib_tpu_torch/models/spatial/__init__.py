from nr3d_lib_tpu_torch.models.spatial.aabb import AABBDynamicSpace, AABBSpace  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.spatial.batched import BatchedBlockSpace, BatchedDynamicSpace  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.spatial.forest import ForestBlockSpace  # noqa: F401,E501
