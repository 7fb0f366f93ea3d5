"""Auto-decoder latents (port of nr3d_lib_tpu/models/autodecoder.py
`AutoDecoderMixin`): each object instance owns a latent code, and a shared
conditional decoder takes it as its z input (DeepSDF-style).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.embeddings import Embedding

__all__ = ["AutoDecoderMixin"]


class AutoDecoderMixin(nn.Module):
    """The per-instance latent table `latents.weight` [n_instances,
    latent_dim]; compose it with a conditional field. `device=None` means
    CUDA (the table is an `Embedding`)."""

    def __init__(self, n_instances: int, latent_dim: int, *,
                 latent_std: float = 0.01, seed: int = 0, device=None):
        super().__init__()
        self.latents = Embedding(n_instances, latent_dim, std=latent_std,
                                 seed=seed, device=device)
        self.latent_dim = latent_dim
        self.n_instances = n_instances

    def get_latent(self, ins_inds: torch.Tensor) -> torch.Tensor:
        return self.latents(ins_inds)

    def mean_latent(self) -> torch.Tensor:
        return self.latents.mean_latent()

    def infer_latent_init(self, generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """A fresh latent N(0, 0.01²) [latent_dim] for the test-time
        optimization of an unseen instance, on the table's device."""
        dev = self.latents.weight.device
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        return 0.01 * torch.randn(self.latent_dim, generator=generator,
                                  device=generator.device).to(dev)
