"""State bridge between a JAX model's state and the port's `state_dict`.

The JAX model's state arrives as numpy arrays keyed by nnx path, joined
with "/" (for example `field/implicit_surface/decoder/ws/0`), so the port
never imports JAX. The port's module tree mirrors the nnx names, so each
path maps to the dotted `state_dict` key of the same name:

  * `.../encoding/flattened_params` — the classic LoTD encoding's flat
    [n_params] vector (`ops/lotd.py` layout) or the brick encoding's, in
    the same layout;
  * decoder and radiance `ws/i`, `bs/i` — the port stores `ws[i]` as
    [in, out] exactly as JAX does and computes `h @ w + b`, so no
    transpose;
  * `field/var_ctrl/ln_s`, `space/aabb`, `accel/occ/val_grid` and
    `accel/occ/it`;
  * the permuto banks' `bank/flattened_params` ([rows, 128·F/2] on the
    cell backend, the classic lattice's flat [n_params]) and the MLL's
    `lattice_layers/i/encoding/flattened_params`, `.../decoder/ws/0`
    and `.../zero`, by the same rule.

The LoTD growers (`lotd_growers.py`) keep the JAX names too: the
Flatten grower's `mlp/ws/i`, the FiLM layers' and `_ModConv`'s `w` (as
[in, out], applied as `h @ w`, so no transpose), `b`, `wz`, `bz`, the FMM
grower's `trunk/i/...`, `heads/i/...`, `pseudo/<level>` and `shared`,
the conv grower's `const` and `blocks/i/...`, the shared grower's `base`,
and the mixed grower's `growers/i/...`.

Booleans (the getter grid's `accel/occ/occ_grid`) and bfloat16 arrays
(parameters with `param_dtype=bfloat16`; numpy holds them as the
`bfloat16` extension dtype) come across in their own dtypes.

A forest model (`LoTDForestNeuSModel`) comes across with
`forest_from_jax_state`: its encoding's `flattened_params` is [n_trees,
n_params] on either backend, passed through as it is; the JAX state lists the shared block space under
`accel/space/`, and of it only `occupied`, `origin` and `block_idx` come
across (the port rebuilds the slots, the block coordinates and the
culling levels from `occupied` when the state is loaded); the accel's EMA
grids are `accel/occ/val_grid`.

An attribute (`models/attributes.py`: a rotation, a transform, camera
intrinsics, a scale or a segment) crosses by its class name and its
fields: `attribute_from_jax("TransformRT", {"rot": ..., "trans": ...})`,
the arrays as numpy (the JAX attribute's leaves) and the image size as
ints.

Gaussian splatting keeps its parameters in a plain dictionary
(experiments/bench_render.py `main_train_gaussian`: `means`, `scales`,
`quats`, `opac`, `cols`); `gaussians_from_jax` makes them trainable
tensors, and `to_jax_paths` takes them back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from nr3d_lib_tpu_torch.device import resolve_device

__all__ = ["from_jax_state", "forest_from_jax_state", "to_jax_paths",
           "gaussians_from_jax", "GAUSSIAN_KEYS", "attribute_from_jax"]

GAUSSIAN_KEYS = ("means", "scales", "quats", "opac", "cols")


def from_jax_state(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{nnx path: numpy array} → {state_dict key: CPU tensor}; load it with
    `model.load_state_dict(sd)` (strict by default, so a missing or
    unexpected key raises)."""
    out = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if arr.dtype == np.float64:
            raise ValueError(f"{path}: float64 state; the model is float32")
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        out[path.replace("/", ".")] = t
    return out


_FOREST_SPACE = "accel/space/"
_FOREST_SPACE_STATE = ("occupied", "origin", "block_idx")


def forest_from_jax_state(flat: Mapping[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """A JAX forest model's {nnx path: numpy array} → the port's state
    dict: the space's state moves from `accel/space/` to `space/`, and
    what the port derives from `occupied` is dropped."""
    out = {}
    for path, value in flat.items():
        if path.startswith(_FOREST_SPACE):
            name = path[len(_FOREST_SPACE):]
            if name not in _FOREST_SPACE_STATE:
                continue
            path = "space/" + name
        out[path] = value
    return from_jax_state(out)


def to_jax_paths(named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: {state_dict key or parameter name: tensor} → {nnx path:
    numpy array}, so that the port's gradients or updated parameters can
    be compared with the JAX package's by path."""
    return {key.replace(".", "/"): t.detach().cpu().numpy()
            for key, t in named.items()}


def gaussians_from_jax(params: Mapping[str, np.ndarray],
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Dict[str, torch.Tensor]:
    """{means, scales, quats, opac, cols: numpy array} → float32 leaf
    tensors on `device` (the card unless "cpu" is asked for) that need
    their gradients, in `GAUSSIAN_KEYS` order. An unknown key raises
    KeyError, a float64 array ValueError."""
    dev = resolve_device(device)
    unknown = set(params) - set(GAUSSIAN_KEYS)
    if unknown:
        raise KeyError(f"not a gaussian parameter: {sorted(unknown)}; "
                       f"expected {GAUSSIAN_KEYS}")
    out = {}
    for key in GAUSSIAN_KEYS:
        if key not in params:
            continue
        arr = np.asarray(params[key])
        if arr.dtype == np.float64:
            raise ValueError(f"{key}: float64 parameters; the rasterizer "
                             f"is float32")
        out[key] = torch.tensor(arr, dtype=torch.float32,
                                device=dev).requires_grad_(True)
    return out


def attribute_from_jax(name: str, fields: Mapping[str, object],
                       device: Optional[Union[str, torch.device]] = None,
                       requires_grad: bool = False):
    """The port's attribute of class `name` (a name of
    `models.attributes.__all__`) from the JAX attribute's fields: arrays
    become float32 (or integer) tensors on `device` (the card unless "cpu"
    is asked for), leaf tensors that need their gradients with
    `requires_grad`; ints (the image size) and None pass as they are. A
    float64 array raises ValueError, an unknown class KeyError, a missing
    or unknown field TypeError."""
    from nr3d_lib_tpu_torch.models import attributes

    if name not in attributes.__all__ or not isinstance(
            getattr(attributes, name), type):
        raise KeyError(f"not an attribute class: {name}")
    dev = resolve_device(device)
    kw = {}
    for key, value in fields.items():
        if value is None or isinstance(value, int):
            kw[key] = value
            continue
        arr = np.asarray(value)
        if arr.dtype == np.float64:
            raise ValueError(f"{name}.{key}: float64; attributes are "
                             f"float32")
        t = torch.tensor(arr, device=dev)
        kw[key] = t.requires_grad_(True) if requires_grad and \
            t.is_floating_point() else t
    return getattr(attributes, name)(**kw)
