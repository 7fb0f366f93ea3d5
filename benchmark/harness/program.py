"""The system under test as the configuration names it: the model class
of the port and its keyword arguments, with the benchmark's weights
loaded by name."""

from __future__ import annotations

import importlib
import sys
import time
from typing import Dict

import torch


def build_model(cfg: dict, device: torch.device):
    mod, cls = cfg["program"]["model"].split(":")
    model_cls = getattr(importlib.import_module(mod), cls)
    return model_cls(**cfg["program"]["kwargs"], device=device)


def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    """Copy every parameter from `weights`; a parameter left out, or a
    weight the model does not have, is an error."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"weights and parameters differ: only in the model "
                       f"{sorted(set(params) - set(weights))}, only in the "
                       f"weights {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} in the model, "
                                 f"{tuple(weights[name].shape)} made")
            p.copy_(weights[name])


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def release(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Phases:
    """Seconds of each set-up phase, synchronised, for standard error."""

    def __init__(self, dev: torch.device):
        self.dev, self.parts = dev, []
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        sync(self.dev)
        t = time.perf_counter()
        self.parts.append(f"{name} {t - self.t:.3f} s")
        self.t = t

    def report(self) -> None:
        print("[setup phases] " + ", ".join(self.parts), file=sys.stderr)
