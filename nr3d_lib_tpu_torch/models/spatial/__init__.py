from nr3d_lib_tpu_torch.models.spatial.aabb import AABBSpace  # noqa: F401
