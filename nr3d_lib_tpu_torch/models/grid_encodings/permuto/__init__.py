from nr3d_lib_tpu_torch.models.grid_encodings.permuto.permuto_encoding import PermutoParams  # noqa: F401,E501
