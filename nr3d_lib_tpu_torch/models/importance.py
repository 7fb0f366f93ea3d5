"""Error-map-driven importance pixel sampling (port of nr3d_lib_tpu/
models/importance.py `ErrorMap`, `ImpSampler`): per-frame error
accumulation on a low-resolution grid, row and column CDFs, and 2D
inverse-CDF pixel sampling mixed with uniform pixels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.raysample import Draw, uniform_draw

__all__ = ["ErrorMap", "ImpSampler"]


class ErrorMap(nn.Module):
    """Per-frame error grid. State: the buffer ``error_map`` [n_frames,
    eh, ew], ones at first. `device=None` means CUDA."""

    def __init__(self, n_frames: int, res: Tuple[int, int] = (128, 128),
                 ema: float = 0.9, device=None):
        super().__init__()
        self.res = tuple(res)
        self.ema = float(ema)
        self.register_buffer("error_map", torch.ones(
            (n_frames,) + self.res, dtype=torch.float32,
            device=resolve_device(device)))

    @torch.no_grad()
    def collect(self, frame_idx, xy: torch.Tensor,
                errors: torch.Tensor) -> None:
        """The EMA of per-ray errors into the cells of xy [N, 2] in [0,1]
        (x right, y down) of frame `frame_idx` (an int or [N]). In
        place."""
        eh, ew = self.res
        ix = torch.clamp((xy[:, 0] * ew).to(torch.int64), 0, ew - 1)
        iy = torch.clamp((xy[:, 1] * eh).to(torch.int64), 0, eh - 1)
        fi = torch.as_tensor(frame_idx, dtype=torch.int64,
                             device=xy.device).expand(ix.shape)
        old = self.error_map[fi, iy, ix]
        self.error_map[fi, iy, ix] = self.ema * old + (1.0 - self.ema) * \
            errors.to(old.dtype)

    def construct_cdf(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the row CDF [F, eh], each row's column CDF [F, eh, ew])."""
        em = self.error_map + 1e-8
        cdf_rows = torch.cumsum(torch.sum(em, -1), -1)
        cdf_cols = torch.cumsum(em, -1)
        return cdf_rows / cdf_rows[..., -1:], cdf_cols / cdf_cols[..., -1:]


class ImpSampler(nn.Module):
    """Inverse-CDF 2D pixel sampler: the first `frac_uniform` of the
    samples are uniform pixels (exploration), the rest follow the error
    map."""

    def __init__(self, error_map: ErrorMap, frac_uniform: float = 0.5):
        super().__init__()
        self.error_map = error_map
        self.frac_uniform = float(frac_uniform)

    def sample_pixel(self, n: int, frame_idx: int,
                     generator: Optional[torch.Generator] = None,
                     draw: Optional[Draw] = None) -> torch.Tensor:
        """→ xy [n, 2] in [0,1]². The uniforms come from `draw` (else
        from `generator`, else a generator seeded with 0), in the JAX
        version's key order: the row [n], the column [n], the in-pixel
        jitter [n, 2], the uniform pixels [n, 2]."""
        dev = self.error_map.error_map.device
        if draw is None:
            draw = uniform_draw(generator if generator is not None else
                                torch.Generator(dev).manual_seed(0))
        cdf_rows, cdf_cols = self.error_map.construct_cdf()
        eh, ew = self.error_map.res
        u_row, u_col = draw((n,), 0.0, 1.0), draw((n,), 0.0, 1.0)
        iy = torch.clamp(torch.searchsorted(
            cdf_rows[frame_idx].contiguous(), u_row.contiguous()), 0, eh - 1)
        ix = torch.searchsorted(cdf_cols[frame_idx][iy].contiguous(),
                                u_col[:, None].contiguous())[:, 0]
        ix = torch.clamp(ix, 0, ew - 1)
        jitter = draw((n, 2), 0.0, 1.0)
        xy_imp = torch.stack([(ix + jitter[:, 0]) / ew,
                              (iy + jitter[:, 1]) / eh], -1)
        xy_uni = draw((n, 2), 0.0, 1.0)
        take_uni = torch.arange(n, device=dev) < int(n * self.frac_uniform)
        return torch.where(take_uni[:, None], xy_uni, xy_imp)
