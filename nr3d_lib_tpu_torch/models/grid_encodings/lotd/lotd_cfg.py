"""LoTD auto-configuration (port of nr3d_lib_tpu/models/grid_encodings/
lotd/lotd_cfg.py: host-side numpy, no JAX in it; copied so that the port
imports nothing of the JAX package).

Computes per-level resolutions/types from the space's aabb stretch and a
target parameter budget — the NGP recipe generalized to cuboid (per-axis)
resolutions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["auto_ngp_cfg", "auto_ngp4d_cfg", "get_lotd_cfg"]


def auto_ngp_cfg(stretch: Union[float, Sequence[float]] = 2.0, *,
                 input_ch: int = 3,
                 target_num_params: int = 2 ** 21,
                 n_levels: int = 16,
                 n_feats: int = 2,
                 log2_hashmap_size: int = 19,
                 min_res: int = 16,
                 per_level_scale: float = 1.382,
                 max_res: Optional[int] = None,
                 dense_until_params: int = 2 ** 14) -> dict:
    """NGP-style multi-level config: geometric resolution growth; levels whose
    dense size fits `dense_until_params` are Dense, the rest Hash
    (reference: lotd_cfg.py auto_ngp_cfg)."""
    stretch = np.broadcast_to(np.asarray(stretch, np.float64), (input_ch,))
    rel = stretch / stretch.min()
    hashmap_size = 2 ** log2_hashmap_size
    # keep total under budget: shrink hashmap if needed
    n_hash_levels_est = n_levels
    while hashmap_size * n_feats * n_hash_levels_est > 2 * target_num_params \
            and hashmap_size > 2 ** 14:
        hashmap_size //= 2

    lod_res, lod_types = [], []
    for l in range(n_levels):
        base = min_res * (per_level_scale ** l)
        res = np.maximum(3, np.floor(base * rel + 0.5).astype(int))
        if max_res is not None:
            res = np.minimum(res, max_res)
        lod_res.append([int(v) for v in res])
        dense_size = int(np.prod(res)) * n_feats
        lod_types.append("Dense" if dense_size <= dense_until_params else "Hash")
    return {"lod_res": lod_res, "lod_n_feats": n_feats, "lod_types": lod_types,
            "hashmap_size": hashmap_size}


def auto_ngp4d_cfg(stretch: Union[float, Sequence[float]] = 1.0, *,
                   dim: int = 4,
                   n_feats: int = 2,
                   target_num_params: int = 2 ** 24,
                   max_levels: int = 128,
                   min_dense_levels: int = 0,
                   log2_hashmap_size: int = 19,
                   min_res_xyz: int = 4,
                   min_res_w: int = 4,
                   per_level_scale: float = 1.382) -> dict:
    """4D (xyz + w) auto-config — NeRF++ background / dynamic (x,t) grids
    (reference capability: lotd_cfg.py:135 auto_ngp4d_cfg). The w axis
    (inverse radius or time) grows from its own `min_res_w`; levels switch
    Dense→Hash once the dense grid outgrows the hashmap (but never before
    `min_dense_levels`), and levels stop when the parameter budget is
    spent or `max_levels` is reached."""
    hashmap_size = 2 ** log2_hashmap_size
    stretch = np.broadcast_to(np.asarray(stretch, np.float64), (dim - 1,))
    base = np.concatenate([min_res_xyz * stretch / stretch.min(),
                           np.asarray([min_res_w], np.float64)])
    lod_res, lod_types, n_params = [], [], 0
    for l in range(max_levels):
        res = np.ceil(base).astype(np.int64)
        # math.prod over python ints: np.prod overflows int64 past ~level
        # 60 and would silently mark huge levels Dense
        n_grids = math.prod(int(v) for v in res)
        if n_grids > hashmap_size and l >= min_dense_levels:
            lvl_type, lvl_params = "Hash", hashmap_size * n_feats
        else:
            lvl_type, lvl_params = "Dense", n_grids * n_feats
        if n_params + lvl_params > target_num_params:
            break
        lod_res.append([int(v) for v in res])
        lod_types.append(lvl_type)
        n_params += lvl_params
        base = base * per_level_scale
    return {"lod_res": lod_res, "lod_n_feats": n_feats, "lod_types": lod_types,
            "hashmap_size": hashmap_size}


def get_lotd_cfg(type: str = "ngp", *, input_ch: int = 3,
                 stretch=2.0, **kwargs) -> dict:
    """Auto-config dispatcher (reference: lotd_cfg.py get_lotd_cfg)."""
    t = type.lower()
    if t in ("ngp", "hash", "auto_ngp"):
        return auto_ngp_cfg(stretch, input_ch=input_ch, **kwargs)
    if t in ("ngp4d", "auto_ngp4d"):
        return auto_ngp4d_cfg(stretch, dim=input_ch if input_ch >= 4 else 4,
                              **kwargs)
    raise ValueError(f"Unknown lotd auto-config type: {type}")
