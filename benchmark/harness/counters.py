"""Counts of the work a traced stretch asks of the field: every call of
the configured encodings (the encode and its nablas) and MLPs, with its
rows, taken at the call from the shapes alone (no device sync). Installed
on the model instance in traced runs only; the program is not changed."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch


@dataclass
class Call:
    module: str        # the module's path in the model
    kind: str          # "fwd", "nablas" or "mlp"
    rows: int
    grad: bool         # its backward runs (a training step's query)
    need_dx: bool      # the backward also gives dL/dx


class Counters:
    """`counted` is the configuration's {"encodings": [...], "mlps":
    [...]} of module paths. `training`: the cell backpropagates through
    the calls made with gradients enabled."""

    def __init__(self, model, counted: dict, training: bool):
        self.calls: List[Call] = []
        self.active = False
        self.training = training
        for path in counted["encodings"]:
            enc = model.get_submodule(path)
            enc.forward = self._wrap(enc.forward, path, "fwd")
            enc.nablas_path = self._wrap(enc.nablas_path, path, "nablas")
        for path in counted["mlps"]:
            m = model.get_submodule(path)
            m.forward = self._wrap(m.forward, path, "mlp")

    def _wrap(self, fn, path: str, kind: str):
        def counted(x, *args, **kwargs):
            if self.active:
                grad = self.training and torch.is_grad_enabled()
                need_dx = grad and x.requires_grad and \
                    not kwargs.get("frozen_x", False)
                self.calls.append(Call(path, kind,
                                       x.numel() // x.shape[-1], grad,
                                       need_dx))
            return fn(x, *args, **kwargs)
        return counted

    def take(self) -> List[Call]:
        calls, self.calls = self.calls, []
        return calls
