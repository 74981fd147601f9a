"""Typed configuration: the dataclasses of photo_slam_tpu/config.py, copied
as plain Python (defaults = reference defaults,
include/gaussian_parameters.h:20-96 and replica_rgbd.yaml). The render path
reads RendererParams: caps_for_mode and initial_capacity.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelParams:
    """(reference: include/gaussian_parameters.h GaussianModelParams)."""

    sh_degree: int = 3
    resolution: float = -1.0
    white_background: bool = False
    eval: bool = False


@dataclass
class PipelineParams:
    """(reference: GaussianPipelineParams)."""

    convert_SHs: bool = False
    compute_cov3D: bool = False


@dataclass
class OptimizationParams:
    """(reference: GaussianOptimizationParams + Optimization.* keys)."""

    max_num_iterations: int = 30000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    prune_big_point_after_iter: int = 30000
    densify_min_opacity: float = 0.005
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densify_grad_threshold: float = 0.0002


@dataclass
class MapperParams:
    """Online-mapper knobs (reference: Mapper.* keys +
    Camera./Monocular./Stereo./RGBD. pipeline params)."""

    z_near: float = 0.01
    z_far: float = 100.0
    monocular_inactive_geo_densify_max_pixel_dist: float = 20.0
    stereo_min_disparity: int = 0
    stereo_num_disparity: int = 128
    rgbd_min_depth: float = 1e-10
    rgbd_max_depth: float = 40.0
    inactive_geo_densify: bool = True
    max_depth_cached: int = 1
    min_num_initial_map_kfs: int = 15
    new_keyframe_times_of_use: int = 3
    local_BA_increased_times_of_use: int = 1
    loop_closure_increased_times_of_use: int = 2
    cull_keyframes: bool = False
    large_rotation_threshold: float = 1.0
    large_translation_threshold: float = 0.001
    stable_num_iter_existence: int = 1
    do_gaus_pyramid_training: bool = True
    num_gaus_pyramid_sub_levels: int = 2
    gaus_pyramid_sub_level_times_of_use: int = 8


@dataclass
class RecordParams:
    """(reference: Record.* keys)."""

    keyframe_record_interval: int = 0
    all_keyframes_record_interval: int = 0
    record_rendered_image: bool = True
    record_ground_truth_image: bool = False
    record_loss_image: bool = False
    training_report_interval: int = 0
    record_loop_ply: bool = False


@dataclass
class ViewerParams:
    """(reference: GaussianViewer.* keys)."""

    glfw_window_width: int = 1400
    glfw_window_height: int = 1050
    image_scale: float = 0.5
    image_scale_main: float = 1.0
    camera_watch_dist: float = 1e-6


@dataclass
class RendererParams:
    """Renderer capacities (no reference equivalent: static caps in place of
    the reference CUDA rasterizer's dynamic allocations; see ops/binning.py).
    The values are the JAX package's, so quality numbers stay comparable;
    their right values on the H100 have not been measured yet."""

    tile: int = 16
    max_tiles_per_gaussian: int = 64
    max_per_tile: int = 512
    tiles_per_chunk: int = 16
    # Kernel-path capacities (32px tiles): the duplication factor scales the
    # binning sort; overflow counters surface when it clips.
    pallas_max_tiles_per_gaussian: int = 6
    pallas_max_per_tile: int = 1024
    # Overflow-continuation passes for recorded/evaluation renders (exact
    # tail compositing; ops/tiled.render_pallas).
    record_overflow_passes: int = 2
    initial_capacity: int = 32768
    capacity_headroom: float = 0.25  # grow when free slots < this fraction
    max_capacity: int = 2 << 20

    def caps_for_mode(self, mode: str) -> tuple[int, int]:
        """(max_tiles_per_gaussian, max_per_tile) for a render mode."""
        if mode == "pallas":
            return self.pallas_max_tiles_per_gaussian, self.pallas_max_per_tile
        return self.max_tiles_per_gaussian, self.max_per_tile


@dataclass
class Config:
    model: ModelParams = field(default_factory=ModelParams)
    pipeline: PipelineParams = field(default_factory=PipelineParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    mapper: MapperParams = field(default_factory=MapperParams)
    record: RecordParams = field(default_factory=RecordParams)
    viewer: ViewerParams = field(default_factory=ViewerParams)
    renderer: RendererParams = field(default_factory=RendererParams)
