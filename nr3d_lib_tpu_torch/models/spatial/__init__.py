from nr3d_lib_tpu_torch.models.spatial.aabb import AABBDynamicSpace, AABBSpace  # noqa: F401,E501
