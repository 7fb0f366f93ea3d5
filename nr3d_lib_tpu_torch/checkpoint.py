"""Checkpoint IO: named objects → one file (port of
nr3d_lib_tpu/checkpoint.py `CheckpointIO`, `sorted_ckpts`).

A checkpoint is a `torch.save` of {name: state_dict} plus `__extras__`
(scalars such as the iteration), read back with
`torch.load(weights_only=True)`. Registered objects are `nn.Module`s,
`torch.optim` optimizers, or anything with `state_dict` and
`load_state_dict`. A module's state is its parameters and buffers: the
port keeps every piece of training state that a resumed run needs there
(the occupancy grids and their update count, the spaces, inv_s, the
latents, the error map); what is a function of the iteration (the anneal
windows, a scheduled inv_s) is set again by the trainer's
`training_before_per_step(it)` from the `it` it saved in the extras, and
the forest space rebuilds its slots when its state is loaded.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = ["CheckpointIO", "sorted_ckpts"]


def sorted_ckpts(ckpt_dir: str, ext: str = ".pt") -> List[str]:
    """Oldest first; the last is the one to resume from: the highest
    iteration, then `latest`, then `final`."""
    paths = sorted(glob(os.path.join(ckpt_dir, f"*{ext}")))
    final, latest, iters = [], [], []
    for p in paths:
        name = os.path.basename(p)
        if "final" in name:
            final.append(p)
        elif "latest" in name:
            latest.append(p)
        else:
            m = re.search(r"(\d+)", name)
            iters.append((int(m.group(1)) if m else -1, p))
    return [p for _, p in sorted(iters)] + latest + final


class CheckpointIO:
    def __init__(self, checkpoint_dir: str = "./ckpts",
                 allow_mkdir: bool = True):
        self.checkpoint_dir = checkpoint_dir
        if allow_mkdir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.module_dict: Dict[str, Any] = {}

    def register_modules(self, **kwargs):
        self.module_dict.update(kwargs)

    def _path(self, filename: str) -> str:
        return filename if os.path.isabs(filename) else \
            os.path.join(self.checkpoint_dir, filename)

    def save(self, filename: str, **extra_scalars) -> str:
        filename = self._path(filename)
        payload = {k: m.state_dict() for k, m in self.module_dict.items()}
        payload["__extras__"] = dict(extra_scalars)
        torch.save(payload, filename)
        return filename

    def load(self, filename: str, ignore_keys: Sequence[str] = (),
             only_use_keys: Optional[Sequence[str]] = None
             ) -> Dict[str, Any]:
        """Load the registered objects' states; returns the extras. The
        file's tensors are read onto the CPU, and each object's
        `load_state_dict` moves them to its own device."""
        if not os.path.exists(filename):
            filename = self._path(filename)
        payload = torch.load(filename, map_location="cpu", weights_only=True)
        extras = payload.pop("__extras__", {})
        for name, state in payload.items():
            if name in ignore_keys or name not in self.module_dict:
                continue
            if only_use_keys is not None and name not in only_use_keys:
                continue
            obj = self.module_dict[name]
            if hasattr(obj, "before_load_state_dict"):
                # a shape-dependent rebuild before the state goes in
                obj.before_load_state_dict(state)
            obj.load_state_dict(state)
        return extras

    def load_latest(self, **kwargs) -> Optional[Dict[str, Any]]:
        ordered = sorted_ckpts(self.checkpoint_dir)
        if not ordered:
            return None
        return self.load(ordered[-1], **kwargs)
