"""Tensor ops of the port: resampling, geometry, the alignment solvers and
the four kernel-backed ops (LayerNorm, flash attention, 3x3 replicate conv,
the camera solve). Importing the package registers the kernels as the
dispatcher ops ``torch.ops.moge.{layer_norm, flash_attention, conv3x3,
camera_solve}`` (``_build.define_op``).

The names are the JAX package's ``moge_tpu.ops``, with one difference:
attention is ``flash_attention`` (kernel K2 on CUDA tensors, which raises
where the kernel cannot run) and ``attention_plain`` (the plain version),
where JAX offers ``scaled_dot_product_attention``, which falls back to its
plain version when its kernel raises. No entry falls back from a kernel."""

from . import alignment, attention, conv, geometry, norm, resize, solvers
from .alignment import (
    align,
    align_affine_lstsq,
    align_depth_affine,
    align_depth_scale,
    align_points_scale,
    align_points_scale_xyz_shift,
    align_points_scale_z_shift,
    align_points_xyz_shift,
    align_points_z_shift,
)
from .attention import attention_plain, flash_attention
from .geometry import (
    angle_between,
    angle_diff_vec3,
    depth_map_edge,
    depth_map_to_normal_map,
    depth_map_to_point_map,
    dilate_with_mask,
    focal_to_fov,
    fov_to_focal,
    gaussian_blur_2d,
    geometric_mean,
    harmonic_mean,
    intrinsics_from_focal_center,
    intrinsics_from_fov,
    intrinsics_to_fov,
    masked_nearest_resize,
    normal_map_edge,
    normalized_view_plane_uv,
    point_map_to_depth_legacy,
    point_map_to_normal_map,
    project_cv,
    refine_depth_with_normal,
    safe_norm,
    sliding_window_2d,
    threshold_depth_change,
    unproject_cv,
    uv_map,
    weighted_mean,
)
from .resize import resize_2d, resize_image, resize_matrix
from .solvers import recover_focal_shift, solve_optimal_focal_shift, solve_optimal_shift
