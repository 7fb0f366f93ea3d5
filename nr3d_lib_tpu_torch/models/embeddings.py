"""Latent embeddings: per-instance, per-frame and per-sequence codes (port
of nr3d_lib_tpu/models/embeddings.py `Embedding`, `SeqEmbedding`,
`MultiSeqEmbeddingShared`, `MultiSeqEmbeddingIndividual`).

The tables are `weight` parameters [n, dim], initialized N(0, std²) from a
seeded `torch.Generator` (the values do not match JAX's random bits; tests
carry the tables across by the state bridge).
"""

from __future__ import annotations

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device

__all__ = ["Embedding", "SeqEmbedding", "MultiSeqEmbeddingShared",
           "MultiSeqEmbeddingIndividual"]


class Embedding(nn.Module):
    """Learnable code table [n, dim]; `forward(idx)` looks codes up.
    `device=None` means CUDA."""

    def __init__(self, num_embeddings: int, dim: int, *, std: float = 0.01,
                 seed: int = 0, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.dim = dim
        gen = torch.Generator().manual_seed(seed)
        self.weight = nn.Parameter(
            (std * torch.randn(num_embeddings, dim, generator=gen)).to(
                resolve_device(device)))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx]

    def mean_latent(self) -> torch.Tensor:
        return torch.mean(self.weight, 0)


class SeqEmbedding(Embedding):
    """Per-timestep codes, linearly interpolated at fractional times."""

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        """ts: float in [0, n−1] → the code interpolated between the two
        neighbouring rows (clamped at the ends)."""
        n = self.num_embeddings
        t0 = torch.clamp(torch.floor(ts).to(torch.int64), 0, n - 1)
        t1 = torch.clamp(t0 + 1, 0, n - 1)
        frac = (ts - t0.to(ts.dtype))[..., None]
        return self.weight[t0] * (1 - frac) + self.weight[t1] * frac


class MultiSeqEmbeddingShared(nn.Module):
    """Several sequences sharing one per-frame table."""

    def __init__(self, n_frames: int, dim: int, **kw):
        super().__init__()
        self.frame_embedding = SeqEmbedding(n_frames, dim, **kw)

    def forward(self, seq_idx: torch.Tensor, ts: torch.Tensor
                ) -> torch.Tensor:
        del seq_idx
        return self.frame_embedding(ts)


class MultiSeqEmbeddingIndividual(nn.Module):
    """A per-sequence code and a per-frame code, concatenated."""

    def __init__(self, n_seqs: int, n_frames: int, seq_dim: int,
                 frame_dim: int, *, seed: int = 0, **kw):
        super().__init__()
        self.seq_embedding = Embedding(n_seqs, seq_dim, seed=seed, **kw)
        self.frame_embedding = SeqEmbedding(n_frames, frame_dim,
                                            seed=seed + 1, **kw)

    def forward(self, seq_idx: torch.Tensor, ts: torch.Tensor
                ) -> torch.Tensor:
        return torch.cat([self.seq_embedding(seq_idx),
                          self.frame_embedding(ts)], -1)
