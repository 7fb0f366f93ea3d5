from nr3d_lib_tpu_torch.models.accelerations.occgrid import OccGridEma, cell_centers  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.accelerations.occgrid_accel import OccGridAccel  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.accelerations.occgrid_batched import OccGridAccelDynamic, OccGridEmaBatched  # noqa: F401,E501
