"""Training-schedule annealers (port of nr3d_lib_tpu/models/annealers.py:
host-side numpy, no JAX in it; copied so that the port imports nothing of
the JAX package)."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = ["AnnealerConstant", "AnnealerLinear", "AnnealerLogSpace",
           "AnnealerMilestones", "get_annealer", "get_anneal_val",
           "MultiresAnnealer"]


class AnnealerConstant:
    def __init__(self, value, **_):
        self.value = value

    def __call__(self, it: int):
        return self.value


class AnnealerLinear:
    """Linear ramp start_val→stop_val over [start_it, stop_it]
    (reference AnnealerLinear)."""

    def __init__(self, start_val, stop_val, start_it: int = 0, stop_it: int = 1, **_):
        self.start_val, self.stop_val = start_val, stop_val
        self.start_it, self.stop_it = start_it, max(stop_it, start_it + 1)

    def __call__(self, it: int):
        a = np.clip((it - self.start_it) / (self.stop_it - self.start_it), 0.0, 1.0)
        return self.start_val + (self.stop_val - self.start_val) * a


class AnnealerLogSpace:
    """Geometric interpolation (reference AnnealerLogSpace; used for inv_s)."""

    def __init__(self, start_val, stop_val, start_it: int = 0, stop_it: int = 1, **_):
        assert start_val > 0 and stop_val > 0
        self.start_val, self.stop_val = start_val, stop_val
        self.start_it, self.stop_it = start_it, max(stop_it, start_it + 1)

    def __call__(self, it: int):
        a = np.clip((it - self.start_it) / (self.stop_it - self.start_it), 0.0, 1.0)
        return float(np.exp(np.log(self.start_val) * (1 - a) + np.log(self.stop_val) * a))


class AnnealerMilestones:
    """Piecewise-constant by milestones (reference AnnealerMilestones)."""

    def __init__(self, milestones: Sequence[int], vals: Sequence, **_):
        assert len(vals) == len(milestones) + 1
        self.milestones = list(milestones)
        self.vals = list(vals)

    def __call__(self, it: int):
        i = int(np.searchsorted(self.milestones, it, side="right"))
        return self.vals[i]


def get_annealer(type: str = "constant", **kwargs):
    t = type.lower()
    return {"constant": AnnealerConstant, "linear": AnnealerLinear,
            "logspace": AnnealerLogSpace, "log": AnnealerLogSpace,
            "milestones": AnnealerMilestones}[t](**kwargs)


def get_anneal_val(it: int, **cfg):
    """One-shot anneal evaluation (reference get_anneal_val)."""
    return get_annealer(**cfg)(it)


class MultiresAnnealer:
    """Per-level window coefficients for progressive grid training
    (reference: grid_encodings/multires_annealer.py). Returns (max_level,
    window [L]) at iteration it; levels fade in coarse→fine."""

    def __init__(self, n_levels: int, stop_it: int, start_it: int = 0,
                 start_level: int = 0, type: str = "hardmask"):
        self.n_levels = n_levels
        self.start_it, self.stop_it = start_it, max(stop_it, start_it + 1)
        self.start_level = start_level
        self.type = type

    def __call__(self, it: int):
        a = np.clip((it - self.start_it) / (self.stop_it - self.start_it), 0.0, 1.0)
        alpha = self.start_level + a * (self.n_levels - self.start_level)
        if self.type == "hardmask":
            max_level = int(np.floor(alpha))
            return max_level, None
        # cosine window (BARF-style soft fade-in)
        bands = np.arange(self.n_levels)
        w = np.clip(alpha - bands, 0.0, 1.0)
        w = 0.5 * (1 - np.cos(np.pi * w))
        return None, w.astype(np.float32)
