from nr3d_lib_tpu_torch.models.grid_encodings.permuto.permuto_encoding import (  # noqa: F401,E501
    PermutoEncoding, PermutoParams)
