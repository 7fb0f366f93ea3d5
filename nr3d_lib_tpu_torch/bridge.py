"""State bridge between a JAX model's state and the port's `state_dict`.

The JAX model's state arrives as numpy arrays keyed by nnx path, joined
with "/" (for example `field/implicit_surface/decoder/ws/0`), so the port
never imports JAX. The port's module tree mirrors the nnx names, so each
path maps to the dotted `state_dict` key of the same name:

  * `.../encoding/flattened_params` — the brick encoding's flat parameter
    vector, in the same layout;
  * decoder and radiance `ws/i`, `bs/i` — the port stores `ws[i]` as
    [in, out] exactly as JAX does and computes `h @ w + b`, so no
    transpose;
  * `field/var_ctrl/ln_s`, `space/aabb`, `accel/occ/val_grid` and
    `accel/occ/it`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_state", "to_jax_paths"]


def from_jax_state(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{nnx path: numpy array} → {state_dict key: CPU tensor}; load it with
    `model.load_state_dict(sd)` (strict by default, so a missing or
    unexpected key raises)."""
    out = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if arr.dtype == np.float64:
            raise ValueError(f"{path}: float64 state; the model is float32")
        out[path.replace("/", ".")] = torch.from_numpy(arr.copy())
    return out


def to_jax_paths(named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: {state_dict key or parameter name: tensor} → {nnx path:
    numpy array}, so that the port's gradients or updated parameters can
    be compared with the JAX package's by path."""
    return {key.replace(".", "/"): t.detach().cpu().numpy()
            for key, t in named.items()}
