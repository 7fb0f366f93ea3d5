"""Losses (JAX's exports of nr3d_lib_tpu/models/loss/__init__.py)."""

from nr3d_lib_tpu_torch.models.loss.recon import (  # noqa: F401
    mse_loss, l1_loss, huber_loss, mape_loss, smape_loss, relative_l2_loss,
    get_recon_loss, reduce)
from nr3d_lib_tpu_torch.models.loss.safe import safe_binary_cross_entropy, clipped_mse  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.loss.ssim import ssim  # noqa: F401
from nr3d_lib_tpu_torch.models.loss.regularization import (  # noqa: F401
    eikonal_loss, normal_smoothness_loss, entropy_regularization,
    distortion_loss)
