"""Typed configuration: the dataclasses of photo_slam_tpu/config.py and its
reference-YAML reader (`load_reference_yaml`), copied as plain Python
(defaults = reference defaults, include/gaussian_parameters.h:20-96 and
replica_rgbd.yaml). The reference reads flat dotted keys from OpenCV
cv::FileStorage YAML files (src/gaussian_mapper.cpp:232-369), including the
`%YAML:1.0` directive that stock YAML parsers reject.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


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


# ---------------------------------------------------------------------------
# Reference cv::FileStorage YAML reader
# ---------------------------------------------------------------------------

def parse_cv_yaml(path) -> dict[str, Any]:
    """Parse the reference's flat OpenCV YAML files into {dotted_key: value}.

    Handles the `%YAML:1.0` directive, comments, and scalar int/float/string
    values — the only constructs the reference configs use.
    """
    out: dict[str, Any] = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith("%"):
            continue
        if ":" not in line:
            continue
        key, _, val = line.partition(":")
        key = key.strip()
        val = val.strip().strip('"')
        if not val:
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


# dotted reference key -> (config group attr, field name, bool?)
_KEYMAP: dict[str, tuple[str, str, bool]] = {
    "Model.sh_degree": ("model", "sh_degree", False),
    "Model.resolution": ("model", "resolution", False),
    "Model.white_background": ("model", "white_background", True),
    "Model.eval": ("model", "eval", True),
    "Pipeline.convert_SHs": ("pipeline", "convert_SHs", True),
    "Pipeline.compute_cov3D": ("pipeline", "compute_cov3D", True),
    "Camera.z_near": ("mapper", "z_near", False),
    "Camera.z_far": ("mapper", "z_far", False),
    "Monocular.inactive_geo_densify_max_pixel_dist":
        ("mapper", "monocular_inactive_geo_densify_max_pixel_dist", False),
    "Stereo.min_disparity": ("mapper", "stereo_min_disparity", False),
    "Stereo.num_disparity": ("mapper", "stereo_num_disparity", False),
    "RGBD.min_depth": ("mapper", "rgbd_min_depth", False),
    "RGBD.max_depth": ("mapper", "rgbd_max_depth", False),
    "Mapper.inactive_geo_densify": ("mapper", "inactive_geo_densify", True),
    "Mapper.depth_cache": ("mapper", "max_depth_cached", False),
    "Mapper.min_num_initial_map_kfs": ("mapper", "min_num_initial_map_kfs", False),
    "Mapper.new_keyframe_times_of_use": ("mapper", "new_keyframe_times_of_use", False),
    "Mapper.local_BA_increased_times_of_use":
        ("mapper", "local_BA_increased_times_of_use", False),
    "Mapper.loop_closure_increased_times_of_use_":
        ("mapper", "loop_closure_increased_times_of_use", False),
    "Mapper.cull_keyframes": ("mapper", "cull_keyframes", True),
    "Mapper.large_rotation_threshold": ("mapper", "large_rotation_threshold", False),
    "Mapper.large_translation_threshold":
        ("mapper", "large_translation_threshold", False),
    "Mapper.stable_num_iter_existence": ("mapper", "stable_num_iter_existence", False),
    "GausPyramid.do": ("mapper", "do_gaus_pyramid_training", True),
    "GausPyramid.num_sub_levels": ("mapper", "num_gaus_pyramid_sub_levels", False),
    "GausPyramid.sub_level_times_of_use":
        ("mapper", "gaus_pyramid_sub_level_times_of_use", False),
    "Record.keyframe_record_interval": ("record", "keyframe_record_interval", False),
    "Record.all_keyframes_record_interval":
        ("record", "all_keyframes_record_interval", False),
    "Record.record_rendered_image": ("record", "record_rendered_image", True),
    "Record.record_ground_truth_image":
        ("record", "record_ground_truth_image", True),
    "Record.record_loss_image": ("record", "record_loss_image", True),
    "Record.training_report_interval":
        ("record", "training_report_interval", False),
    "Record.record_loop_ply": ("record", "record_loop_ply", True),
    "Optimization.max_num_iterations": ("opt", "max_num_iterations", False),
    "Optimization.position_lr_init": ("opt", "position_lr_init", False),
    "Optimization.position_lr_final": ("opt", "position_lr_final", False),
    "Optimization.position_lr_delay_mult": ("opt", "position_lr_delay_mult", False),
    "Optimization.position_lr_max_steps": ("opt", "position_lr_max_steps", False),
    "Optimization.feature_lr": ("opt", "feature_lr", False),
    "Optimization.opacity_lr": ("opt", "opacity_lr", False),
    "Optimization.scaling_lr": ("opt", "scaling_lr", False),
    "Optimization.rotation_lr": ("opt", "rotation_lr", False),
    "Optimization.percent_dense": ("opt", "percent_dense", False),
    "Optimization.lambda_dssim": ("opt", "lambda_dssim", False),
    "Optimization.densification_interval": ("opt", "densification_interval", False),
    "Optimization.opacity_reset_interval": ("opt", "opacity_reset_interval", False),
    "Optimization.prune_big_point_after_iter":
        ("opt", "prune_big_point_after_iter", False),
    "Optimization.densify_min_opacity": ("opt", "densify_min_opacity", False),
    "Optimization.densify_from_iter": ("opt", "densify_from_iter", False),
    "Optimization.densify_until_iter": ("opt", "densify_until_iter", False),
    "Optimization.densify_grad_threshold": ("opt", "densify_grad_threshold", False),
    "GaussianViewer.glfw_window_width": ("viewer", "glfw_window_width", False),
    "GaussianViewer.glfw_window_height": ("viewer", "glfw_window_height", False),
    "GaussianViewer.image_scale": ("viewer", "image_scale", False),
    "GaussianViewer.image_scale_main": ("viewer", "image_scale_main", False),
    "GaussianViewer.camera_watch_dist": ("viewer", "camera_watch_dist", False),
}


def dataset_config(app: str) -> Config:
    """Per-dataset benchmark Config, mirroring the reference's shipped
    gaussian_mapper YAMLs (cfg/gaussian_mapper/<Sensor>/<Dataset>/*.yaml),
    as photo_slam_tpu/config.py::dataset_config does.

    The reference never runs its benchmark apps on the C++ parameter
    defaults: every example passes a per-dataset YAML whose values differ
    materially from the ctor defaults (most importantly
    `opacity_reset_interval: 0` in 40 of 42 shipped configs and
    `densify_grad_threshold: 0.001` in 39 of 42; the ctor defaults are the
    3DGS offline-training values). The apps apply these when no --cfg is
    given, so a bare CLI run follows the benchmark protocol too.
    """
    cfg = Config()
    o, m = cfg.opt, cfg.mapper
    # Common to every benchmark config (e.g. RGB-D/Replica/replica_rgbd.yaml
    # :55-73): constant position LR, no opacity resets, no big-point prune.
    o.position_lr_init = 0.00032
    o.position_lr_final = 0.00032
    o.position_lr_max_steps = 24
    o.densify_grad_threshold = 0.001
    o.opacity_reset_interval = 0
    o.prune_big_point_after_iter = 30000
    o.max_num_iterations = 30100
    m.min_num_initial_map_kfs = 10
    m.new_keyframe_times_of_use = 8
    m.local_BA_increased_times_of_use = 0
    m.large_rotation_threshold = 20.0
    m.large_translation_threshold = 0.5
    m.max_depth_cached = 10
    if app in ("replica_rgbd", "replica_mono"):
        o.densify_min_opacity = 0.02
        o.densify_from_iter = 600
        o.densify_until_iter = 15000
        if app == "replica_mono":
            m.min_num_initial_map_kfs = 20
    elif app in ("tum_rgbd", "tum_mono", "realsense_rgbd"):
        o.densify_min_opacity = 0.1
        o.densify_from_iter = 800 if app == "tum_mono" else 1000
        o.densify_until_iter = 30000
        m.new_keyframe_times_of_use = 2
        m.large_rotation_threshold = 30.0
        m.large_translation_threshold = 1.0
        if app == "tum_mono":
            m.min_num_initial_map_kfs = 20
    elif app == "euroc_stereo":
        o.densify_min_opacity = 0.005
        o.densify_from_iter = 1000
        o.densify_until_iter = 60000
        o.max_num_iterations = 60100
        m.inactive_geo_densify = False
        m.max_depth_cached = 4
        m.min_num_initial_map_kfs = 40
        m.new_keyframe_times_of_use = 2
        m.large_rotation_threshold = 10.0
        m.large_translation_threshold = 0.1
        m.stereo_min_disparity = 96
    return cfg


def load_reference_yaml(path, base: Config | None = None) -> Config:
    """Build a Config from a reference gaussian_mapper YAML file."""
    cfg = base or Config()
    raw = parse_cv_yaml(path)
    for key, value in raw.items():
        entry = _KEYMAP.get(key)
        if entry is None:
            continue
        group, name, is_bool = entry
        if is_bool:
            value = bool(int(value)) if not isinstance(value, str) else bool(value)
        target = getattr(cfg, group)
        setattr(target, name, value)
    return cfg
