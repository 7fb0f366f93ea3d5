"""Acceleration structures: occupancy grids and their ray marches (port of
nr3d_lib_tpu/models/accelerations/__init__.py, with the `get_accel`
factory)."""

from nr3d_lib_tpu_torch.models.accelerations.occgrid import (  # noqa: F401
    OccGridEma, OccGridGetter, cell_centers)
from nr3d_lib_tpu_torch.models.accelerations.occgrid_accel import OccGridAccel  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.accelerations.occgrid_batched import (  # noqa: F401,E501
    OccGridAccelBatched, OccGridAccelBatchedDynamic, OccGridAccelDynamic,
    OccGridAccelStaticAndDynamic, OccGridEmaBatched)
from nr3d_lib_tpu_torch.models.accelerations.occgrid_forest import OccGridAccelForest  # noqa: F401,E501


def get_accel(type: str = "occ_grid", **kwargs):
    """Acceleration-structure factory, by the JAX package's type names;
    an unknown type raises ValueError."""
    t = type.lower()
    if t in ("occ_grid", "occgrid", "occ_grid_ema", "occ_grid_getter"):
        return OccGridAccel(use_ema=("getter" not in t), **kwargs)
    if t in ("occ_grid_batched", "occ_grid_batched_ema"):
        return OccGridAccelBatched(**kwargs)
    if t in ("occ_grid_batched_dynamic",):
        return OccGridAccelBatchedDynamic(**kwargs)
    if t in ("occ_grid_dynamic",):
        return OccGridAccelDynamic(**kwargs)
    if t in ("occ_grid_static_and_dynamic",):
        return OccGridAccelStaticAndDynamic(**kwargs)
    if t in ("occ_grid_forest",):
        return OccGridAccelForest(**kwargs)
    raise ValueError(f"Unknown accel type: {type}")
