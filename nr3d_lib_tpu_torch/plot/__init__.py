"""Plotting helpers of the port (port of nr3d_lib_tpu/plot/). The array
functions run without matplotlib; the few that draw on matplotlib
objects import it inside the function."""

from nr3d_lib_tpu_torch.plot.plot_basic import (  # noqa: F401
    color_depth,
    color_error_map,
    colorize_normals,
    draw_segments_2d,
    figure_to_image,
    gallery,
    overlay_mask,
    sdf_slice_image,
)
from nr3d_lib_tpu_torch.plot.plot_3d import (  # noqa: F401
    camera_frustum_lines,
    forest_block_lines,
    merge_linesets,
    obb_lines,
    occgrid_box_lines,
    plot_lineset,
    trajectory_lines,
)
from nr3d_lib_tpu_torch.plot.plot_2d import (  # noqa: F401
    choose_contrast_color,
    draw_2dbox_labeled,
    draw_bool_mask,
    draw_int_mask,
    draw_patch,
    get_n_ind_colors,
)
