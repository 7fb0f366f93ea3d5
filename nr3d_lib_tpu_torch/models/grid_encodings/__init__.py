"""Grid encodings of the port: the classic and brick LoTD, the
permutohedral lattices, and their shared helpers."""

from nr3d_lib_tpu_torch.models.grid_encodings.utils import (  # noqa: F401
    get_multires_decoder, gridsample1d, trilinear_interp)
from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_cfg import (  # noqa: F401,E501
    auto_ngp_cfg, auto_ngp4d_cfg, get_lotd_cfg)
from nr3d_lib_tpu_torch.ops.permuto import (  # noqa: F401
    PermutoEncMeta, make_permuto_meta, permuto_encode,
    permuto_enc_fwd_dydx, permuto_enc_bwd_dydx)
from nr3d_lib_tpu_torch.models.grid_encodings.permuto.permuto_encoding import (  # noqa: F401,E501
    PermutoEncoding)
