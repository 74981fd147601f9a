"""Public differentiable render API.

Counterpart of photo_slam_tpu/ops/render.py (reference:
src/gaussian_renderer.cpp:23-149): a function of activated Gaussian
attributes, differentiable with respect to means3d, scales, quats,
opacities, shs / colors_precomp and means2d_offset. The reference's
zero `screenspace_points` tensor with retain_grad (the densification
statistic) is the explicit `means2d_offset` argument: pass zeros and take
the gradient with respect to it. `render` dispatches op by op;
`render_jit` replays it from a CUDA graph captured per settings and input
shape (utils/graphs.py), the counterpart of JAX's jitted render, and the
serving paths (the recorder, render_from_pose and so the viewer,
view_result) go through it. mode="pallas" is the hand-written kernel path
(ops/tiled.render_pallas), mode="dense" the exact oracle (ops/dense.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from photo_slam_tpu_torch.ops import dense as dense_mod
from photo_slam_tpu_torch.ops import preprocess as prep_mod
from photo_slam_tpu_torch.ops import tiled as tiled_mod
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.utils.graphs import GraphCache


class RenderSettings(NamedTuple):
    """Rasterization settings: the fields of the JAX package's. `tile` and
    `tiles_per_chunk` belong to the JAX "tiled" mode, which the port does
    not have; they are kept so settings carry across unchanged, and the
    default mode is the kernel path."""

    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    sh_degree: int = 3
    scale_modifier: float = 1.0
    tile: int = 16
    max_tiles_per_gaussian: int = 64
    max_per_tile: int = 512
    tiles_per_chunk: int = 16
    mode: str = "pallas"  # "pallas" | "dense"
    # Overflow continuation (pallas mode): extra blend passes over the
    # entries beyond max_per_tile of overflowing tiles, each covering another
    # overflow_capacity entries; exact (C += T_prev * C_pass, T *= T_pass).
    overflow_passes: int = 1
    overflow_capacity: int = 512
    # Principal point (cx, cy) for off-center cameras; None = image center.
    principal: Optional[tuple] = None
    # Continuation passes run only over this many overflowed tiles with the
    # most residual light. 0 = every tile gets a continuation window.
    overflow_compact: int = 128


def principal_for(camera, width: int, height: int):
    """(cx, cy) scaled to a render of (width, height) for an off-center
    camera, or None when the camera is (effectively) centered
    (photo_slam_tpu/ops/render.py::principal_for)."""
    sx = width / camera.width
    sy = height / camera.height
    cx, cy = camera.cx * sx, camera.cy * sy
    if abs(cx - 0.5 * width) < 1e-6 and abs(cy - 0.5 * height) < 1e-6:
        return None
    return (float(cx), float(cy))


class RenderResult(NamedTuple):
    image: torch.Tensor          # [3, H, W]
    radii: torch.Tensor          # [N] int32
    visible: torch.Tensor        # [N] bool (radii > 0)
    final_T: torch.Tensor        # [H, W]
    n_contrib: torch.Tensor      # [H, W]
    num_clipped: torch.Tensor    # [] int32 binning diagnostics (0 for dense)
    num_overflow: torch.Tensor   # [] int32
    # Overflow-shape probes (pre-continuation): tiles whose raw depth exceeds
    # max_per_tile, and the deepest tile's raw entry count.
    num_overflow_tiles: Optional[torch.Tensor] = None
    max_tile_depth: Optional[torch.Tensor] = None


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    cam: CameraMatrices,
    settings: RenderSettings,
    bg_color: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    live_mask: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Render a view of the Gaussian map on the device of its tensors.

    All Gaussian attributes are ACTIVATED values: scales = exp(log_scale),
    quats normalized, opacities = sigmoid(logit) with shape [N].
    """
    prep = prep_mod.preprocess(
        means3d, scales, quats, cam.viewmatrix, cam.full_proj,
        cam.cam_center, settings.width, settings.height, settings.tan_fovx,
        settings.tan_fovy, sh_degree=settings.sh_degree, shs=shs,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
        scale_modifier=settings.scale_modifier, live_mask=live_mask,
        principal=settings.principal,
    )
    if means2d_offset is not None:
        prep = prep._replace(means2d=prep.means2d + means2d_offset)

    zero = torch.zeros((), dtype=torch.int32, device=means3d.device)
    if settings.mode == "dense":
        out = dense_mod.render_dense(prep, opacities, settings.width,
                                     settings.height, bg_color)
        clipped = overflow = over_tiles = max_depth = zero
    elif settings.mode == "pallas":
        out, binning = tiled_mod.render_pallas(
            prep, opacities, settings.width, settings.height, bg_color,
            max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
            max_per_tile=settings.max_per_tile,
            overflow_passes=settings.overflow_passes,
            overflow_capacity=settings.overflow_capacity,
            overflow_compact=settings.overflow_compact,
        )
        clipped, overflow = binning.num_clipped, binning.num_overflow
        over_tiles = (binning.raw_counts > settings.max_per_tile).sum(
            dtype=torch.int32)
        max_depth = binning.raw_counts.max()
    else:
        raise ValueError(f"render mode {settings.mode!r}: the port has "
                         "'pallas' (kernel path) and 'dense'")

    return RenderResult(
        image=out.image,
        radii=prep.radii,
        visible=prep.visible,
        final_T=out.final_T,
        n_contrib=out.n_contrib,
        num_clipped=clipped,
        num_overflow=overflow,
        num_overflow_tiles=over_tiles,
        max_tile_depth=max_depth,
    )


# The serving renders' graphs: one owner, so one memory pool, shared by
# every thread that renders (the cache serializes their replays).
RENDER_GRAPHS = GraphCache()


def drop_render_graphs(rows: int) -> None:
    """Drop the render graphs of maps of `rows` Gaussians, and their input
    buffers (a copy of such a map): a map that grows past `rows` calls
    this, as JAX's cache stops using the old shape's programs."""
    RENDER_GRAPHS.evict(lambda e: e.fresh[0].shape[0] == rows)


def render_jit(means3d, scales, quats, opacities, cam: CameraMatrices,
               settings: RenderSettings, bg_color, shs=None,
               colors_precomp=None, live_mask=None) -> RenderResult:
    """`render` replayed from a CUDA graph (RENDER_GRAPHS) keyed like the
    JAX package's _jitted_render (the settings and which of shs,
    colors_precomp and live_mask are given) plus the inputs' shapes and
    device: a new image size, SH degree or capacity captures anew. The
    inputs are copied into the graph's buffers; the result's tensors are
    clones, so a later replay does not overwrite them. Not differentiable.
    Serving paths go through this (photo_slam_tpu/ops/render.py:206-215).
    On CPU tensors it calls render directly."""
    key, fresh = render_jit_args(means3d, scales, quats, opacities, cam,
                                 settings, bg_color, shs, colors_precomp,
                                 live_mask)
    flags = key[2]

    def fn(means3d, scales, quats, opacities, view, proj, center, bg, *rest):
        rest = iter(rest)
        opt = [next(rest) if f else None for f in flags]
        res = render(means3d, scales, quats, opacities,
                     CameraMatrices(view, proj, center), settings, bg,
                     shs=opt[0], colors_precomp=opt[1], live_mask=opt[2])
        return tuple(res)

    with torch.no_grad():
        out = RENDER_GRAPHS.run(key, fn, fresh, clone=True)
    return RenderResult(*out)


def render_jit_args(means3d, scales, quats, opacities, cam, settings,
                    bg_color, shs=None, colors_precomp=None,
                    live_mask=None) -> tuple:
    """(key, fresh inputs) of a render_jit call: the key is ("render",
    settings, which of shs, colors_precomp, live_mask are given); the
    graph cache adds the inputs' shapes and device (GraphCache.key_of)."""
    flags = (shs is not None, colors_precomp is not None,
             live_mask is not None)
    given = [x for x in (shs, colors_precomp, live_mask) if x is not None]
    return (("render", settings, flags),
            (means3d, scales, quats, opacities, *cam, bg_color, *given))
