"""nr3d_lib's NeuS object recipe on a time-conditioned model: each ray of
the batch carries its own timestamp, uniform in [-1, 1] (the frames of one
sequence spread over its time span), and the loss is the rendered
colour's MSE to the views' colours plus the configuration's
`train.eikonal` weight times the eikonal term over every final sample
slot of the query (the `neus_object` recipe's objective)."""

from __future__ import annotations

from typing import Optional

import torch


def sample(views, n: int, gen: torch.Generator) -> dict:
    """The batch of a step: `n` rays with their target colours, then a
    timestamp a ray from the same generator."""
    batch = views.sample(n, gen)
    batch["ts"] = torch.rand(n, generator=gen, device=gen.device) * 2.0 - 1.0
    return batch


def measurable(model, cfg: dict) -> None:
    """The cell counts the encoding work at each counted encoding's entry
    points (`forward`, `nablas_path`), which the traced runs wrap
    (`harness/counters.py`). A program whose encoding lacks them could
    run untraced but not traced, so every run of the cell refuses it."""
    for path in cfg["counted"]["encodings"]:
        enc = model.get_submodule(path)
        if type(enc).forward is torch.nn.Module.forward or \
                not callable(getattr(enc, "nablas_path", None)):
            raise TypeError(f"{path} ({type(enc).__name__}) has no forward "
                            f"and nablas_path for the cell to count")


def loss(model, batch: dict, gen: torch.Generator, cfg: dict,
         rows: Optional[int] = None):
    """(loss, rgb loss) of the program's query on `batch`. `rows` takes
    the means over the batch's first `rows` rays only (a planted fault:
    part of the batch left out)."""
    measurable(model, cfg)
    tested = model.ray_test(batch["o"], batch["d"])
    tested["ts"] = batch["ts"]
    rendered, vb = model.ray_query(tested, generator=gen)
    nab, rgb, want = vb["nablas"], rendered["rgb_volume"], batch["rgb"]
    if rows is not None:
        nab, rgb, want = nab[:rows], rgb[:rows], want[:rows]
    eik = torch.mean((torch.linalg.norm(nab, dim=-1) - 1.0) ** 2)
    rgb_l = torch.mean((rgb - want) ** 2)
    return rgb_l + cfg["train"]["eikonal"] * eik, rgb_l
