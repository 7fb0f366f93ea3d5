"""Field nets of the port (JAX's exports of
nr3d_lib_tpu/models/fields/__init__.py)."""

from nr3d_lib_tpu_torch.models.fields.nerf import LoTDNeRF, MlpNeRF, PermutoNeRF, RadianceNet  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.fields.sdf import LoTDSDF, MlpSDF, PermutoSDF  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.fields.neus import LoTDNeuS, MlpNeuS, PermutoNeuS, get_neus_var_ctrl  # noqa: F401,E501
