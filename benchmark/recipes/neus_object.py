"""nr3d_lib's NeuS object recipe, as `examples_torch/train_neus_object.py`
trains it: the rendered colour's MSE to the views' colours plus the
configuration's `train.eikonal` weight times the eikonal term over every
final sample slot of the query."""

from __future__ import annotations

from typing import Optional

import torch


def sample(views, n: int, gen: torch.Generator) -> dict:
    """The batch of a step: `n` rays with their target colours."""
    return views.sample(n, gen)


def loss(model, batch: dict, gen: torch.Generator, cfg: dict,
         rows: Optional[int] = None):
    """(loss, rgb loss) of the program's query on `batch`. `rows` takes
    the means over the batch's first `rows` rays only (a planted fault:
    part of the batch left out)."""
    rendered, vb = model.ray_query(model.ray_test(batch["o"], batch["d"]),
                                   generator=gen)
    nab, rgb, want = vb["nablas_packed"], rendered["rgb_volume"], batch["rgb"]
    if rows is not None:
        nab = nab.reshape(batch["o"].shape[0], -1, 3)[:rows]
        rgb, want = rgb[:rows], want[:rows]
    eik = torch.mean((torch.linalg.norm(nab, dim=-1) - 1.0) ** 2)
    rgb_l = torch.mean((rgb - want) ** 2)
    return rgb_l + cfg["train"]["eikonal"] * eik, rgb_l
