"""Multi-view batched training on one device: B views, one Adam step.

Counterpart of the single-device half of
photo_slam_tpu/parallel/sharding.py (`batched_loss`,
`_accumulate_view_grads` and `train_step_batched` without a mesh). Every
view renders and differentiates the same map; the gradients and the
view-space gradient of densification are summed over the views and scaled
by 1/B, a Gaussian counts as visible if any view sees it and its radius is
the largest over the views, and one masked Adam step follows.

Each view runs its own forward and backward at the single-view shapes, one
after the other, and its graph is freed before the next view starts: the
JAX package measured one graph over all B views (a vmap) at about twice the
cost per view (sharding.py:79-91). So the batch reduces gradient noise; on
one device it is no speed-up over B single-view steps.

The multi-process half takes a torch.distributed process group where JAX
takes a mesh (parallel/launch.py makes the group and its processes; every
function's `group=None` is the single-device path above, unchanged):

  * the view-parallel step: train_step_batched(..., group) runs each rank's
    own views (shard_batch_args), then one sum of the loss, the gradients
    and the view-space gradient (one flat buffer), the MAX of the radii
    and the OR of the visibility, and the same Adam step on every rank's
    replica of the map (replicate);
  * the tile-band render (render_image_sharded, the serving axis): every
    rank renders a band of tile rows of the same view through the kernel
    path and the bands are gathered;
  * the Gaussian-sharded step (shard_gaussian_state,
    train_step_gaussian_sharded, densify_step_gaussian_sharded,
    deal_gaussian_shards, gather_gaussian_state): each rank holds a block
    of the map's rows and its Adam moments, preprocesses them, and the
    screen features are gathered so that every rank renders its band of
    the full frame.

The collectives and their transposes are in parallel/collectives.py.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from photo_slam_tpu_torch.models import densify as dz
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops import losses
from photo_slam_tpu_torch.ops import preprocess as prep_mod
from photo_slam_tpu_torch.ops import tiled as tiled_mod
from photo_slam_tpu_torch.ops.binning import tile_grid
from photo_slam_tpu_torch.ops.blend import TILE_PS
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.parallel import collectives as coll


def _view_loss(params, m2d_offset, live, cam, gt, mask, bg_color,
               lambda_dssim, settings):
    """One view's masked training loss, radii and visibility."""
    scales, quats, opac = gm.activated(params)
    res = render(params.xyz, scales, quats, opac, cam, settings, bg_color,
                 shs=gm.sh_features(params), live_mask=live,
                 means2d_offset=m2d_offset)
    masked = res.image * mask[None]
    return (losses.training_loss(masked, gt, lambda_dssim), res.radii,
            res.visible)


def _view(cams: CameraMatrices, b: int) -> CameraMatrices:
    return CameraMatrices(*(x[b] for x in cams))


def batched_loss(state: gm.GaussianState, cams: CameraMatrices,
                 gt_images: torch.Tensor, masks: torch.Tensor,
                 bg_color: torch.Tensor, lambda_dssim: float,
                 settings: RenderSettings):
    """The mean loss over a batch of views, as a function of the parameters
    and the means2d offset: total(params, m2d_offset) -> (mean loss,
    (radii [B, C], visible [B, C])).

    cams: CameraMatrices with a leading batch dim on every field;
    gt_images [B, 3, H, W]; masks [B, H, W]. Differentiating `total` builds
    one graph over all B views; the train step does not (see
    train_step_batched)."""
    live = state.live

    def total(params, m2d_offset):
        out = [_view_loss(params, m2d_offset, live, _view(cams, b),
                          gt_images[b], masks[b], bg_color, lambda_dssim,
                          settings) for b in range(gt_images.shape[0])]
        loss_b, radii, visible = zip(*out)
        return (torch.stack(loss_b).mean(),
                (torch.stack(radii), torch.stack(visible)))

    return total


def _accumulate_view_grads(params, live, offset0, cams, gt_images, masks,
                           bg_color, lambda_dssim, settings):
    """Per-view loss and gradients, accumulated view by view at the
    single-view shapes (each view's graph is freed before the next).

    Returns (loss_sum, grad_sum, g2d_sum, visible_any, radii_max) over the
    views: grad_sum a GaussianParams of summed gradients, g2d_sum the
    summed gradient of the means2d offset [C, 2]."""
    cap = live.shape[0]
    grad_sum = [torch.zeros_like(p) for p in params]
    g2d_sum = torch.zeros((cap, 2), dtype=torch.float32, device=live.device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=live.device)
    visible_any = torch.zeros(cap, dtype=torch.bool, device=live.device)
    radii_max = torch.zeros(cap, dtype=torch.int32, device=live.device)
    for b in range(gt_images.shape[0]):
        leaves = gm.GaussianParams(*(p.detach().requires_grad_(True)
                                     for p in params))
        offset = offset0.detach().requires_grad_(True)
        loss, radii, visible = _view_loss(
            leaves, offset, live, _view(cams, b), gt_images[b], masks[b],
            bg_color, lambda_dssim, settings)
        grads = torch.autograd.grad(loss, [*leaves, offset],
                                    allow_unused=True)
        with torch.no_grad():
            for acc, g in zip(grad_sum, grads[:-1]):
                if g is not None:
                    acc += g
            if grads[-1] is not None:
                g2d_sum += grads[-1]
            loss_sum += loss.detach()
            visible_any |= visible
            radii_max = torch.maximum(radii_max, radii.to(torch.int32))
    return (loss_sum, gm.GaussianParams(*grad_sum), g2d_sum, visible_any,
            radii_max)


def train_step_batched(
    state: gm.GaussianState,
    opt_state: optim.AdamState,
    cams: CameraMatrices,
    gt_images: torch.Tensor,
    masks: torch.Tensor,
    lrs: optim.LearningRates,
    bg_color: torch.Tensor,
    lambda_dssim: float,
    settings: RenderSettings,
    lock=None,
    group=None,
    profiler=None,
):
    """One multi-view optimization step (B views, mean gradient), the B
    views one after the other on the state's device, then one shared Adam
    update written in place. `lock` (a context manager, e.g. the mapper's
    render lock) is held around the state writes: the densification
    statistics and Adam. Returns (state, opt_state, {"loss", "num_visible"})
    with 0-d tensors.

    With a process group of n ranks, each rank passes its own B/n views
    (shard_batch_args) and its replica of the map (replicate): the sums
    over the views, the radii's max and the visibility's OR are then taken
    over all ranks (JAX's psum and pmax over "dp", sharding.py:158-177),
    and every rank makes the same Adam step. `profiler` times the
    collectives (parallel/collectives.py)."""
    offset0 = torch.zeros((state.capacity, 2), dtype=torch.float32,
                          device=state.live.device)
    b = gt_images.shape[0]
    loss_s, grads_s, g2d_s, visible, radii = _accumulate_view_grads(
        state.params, state.live, offset0, cams, gt_images, masks, bg_color,
        lambda_dssim, settings)
    if group is not None:
        b *= coll.size_of(group)
        loss_s, g2d_s, *grads_s = coll.all_reduce_flat(
            [loss_s, g2d_s, *grads_s], group, profiler=profiler)
        grads_s = gm.GaussianParams(*grads_s)
        radii, visible = coll.all_reduce_max(
            torch.stack([radii, visible.to(torch.int32)]), group,
            profiler=profiler)
        visible = visible.bool()
    inv_b = 1.0 / b
    with torch.no_grad(), (lock or contextlib.nullcontext()):
        grads = gm.GaussianParams(*(g * inv_b for g in grads_s))
        # Stats: visible in ANY view, radii the max; the view-space
        # gradient accumulates the batch mean once, like the loss gradient.
        state = dz.update_max_radii(state, radii, visible)
        state = dz.add_densification_stats(state, g2d_s * inv_b, visible,
                                           settings.width, settings.height)
        params, opt_state = optim.adam_step(state.params, grads, opt_state,
                                            lrs, state.live)
    return state._replace(params=params), opt_state, {
        "loss": loss_s * inv_b,
        "num_visible": visible.sum(dtype=torch.int32)}


def shard_batch_args(group, cams: CameraMatrices, gt_images: torch.Tensor,
                     masks: torch.Tensor):
    """This rank's contiguous B/n slice of a batch (cams with a leading
    batch dim, gt_images [B, 3, H, W], masks [B, H, W]); JAX places the
    same slices with NamedSharding(mesh, P("dp")). Raises unless n divides
    B."""
    n, rank = coll.size_of(group), coll.rank_of(group)
    b = gt_images.shape[0]
    if b % n:
        raise ValueError(f"shard_batch_args: a batch of {b} over {n} ranks")
    sl = slice(rank * (b // n), (rank + 1) * (b // n))
    return (CameraMatrices(*(x[sl] for x in cams)), gt_images[sl],
            masks[sl])


def replicate(group, tree):
    """Group rank 0's tensors on every rank: each tensor of the tree
    (nested tuples, lists, NamedTuples, dicts) broadcast into a new one;
    other leaves as they are."""
    return coll.map_tensors(lambda t: coll.broadcast(t, group), tree)


def band_rows(height: int, n: int) -> int:
    """Rows of each rank's band: whole tile rows, the image's tile rows
    split over n ranks and rounded up (bands past the image are empty)."""
    tile_rows = -(-height // TILE_PS)
    return -(-tile_rows // n) * TILE_PS


def _shift_rows(means2d: torch.Tensor, y0: int) -> torch.Tensor:
    """means2d moved into a band's pixel frame (y - y0), without a copy
    from the host."""
    return torch.stack([means2d[:, 0], means2d[:, 1] - float(y0)], dim=-1)


def _frame(bands: torch.Tensor, height: int) -> torch.Tensor:
    """[n, 3, band, W] bands -> the [3, H, W] image."""
    n, c, band, w = bands.shape
    return bands.permute(1, 0, 2, 3).reshape(c, n * band, w)[:, :height]


def _render_band(prep, opacities, settings: RenderSettings, band: int,
                 bg_color):
    """The kernel path over a band of `band` rows (prep in the band's
    frame), its binning keys laid out for the whole frame's tiles, so that
    depths tie where the single render's do. JAX sizes the keys for the
    band: a band of fewer tiles codes depth in more bits and can sort
    depths that tie in the frame's code by depth, where the frame keeps
    them in entry order (the card's radix sort)."""
    gx, gy = tile_grid(settings.width, settings.height, TILE_PS)
    return tiled_mod.render_pallas(
        prep, opacities, settings.width, band, bg_color,
        max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
        max_per_tile=settings.max_per_tile,
        overflow_passes=settings.overflow_passes,
        overflow_capacity=settings.overflow_capacity,
        overflow_compact=settings.overflow_compact, key_tiles=gx * gy)


def render_image_sharded(group, means3d, scales, quats, opacities,
                         cam: CameraMatrices, settings: RenderSettings,
                         bg_color, shs=None, colors_precomp=None,
                         live_mask=None, profiler=None) -> torch.Tensor:
    """One view, rendered in horizontal bands of tile rows over the ranks
    of `group` (the serving-latency axis; JAX sharding.py:197-271). The
    map is replicated: every rank preprocesses all of it, shifts the
    projected means into its band (y0 = rank * band_rows), renders the band
    through the kernel path, and the bands are gathered. Returns the full
    [3, H, W] image on every rank. Per-tile lists, and so the image, equal
    the single render's while no Gaussian's tile count is clipped to
    max_tiles_per_gaussian (a clipped rect may keep other tiles when the
    band clips it)."""
    if settings.mode != "pallas":
        raise ValueError(f"render_image_sharded: mode {settings.mode!r}; "
                         "the port renders bands with the kernel path")
    band = band_rows(settings.height, coll.size_of(group))
    prep = prep_mod.preprocess(
        means3d, scales, quats, cam.viewmatrix, cam.full_proj,
        cam.cam_center, settings.width, settings.height, settings.tan_fovx,
        settings.tan_fovy, sh_degree=settings.sh_degree, shs=shs,
        colors_precomp=colors_precomp,
        scale_modifier=settings.scale_modifier, live_mask=live_mask,
        principal=settings.principal)
    prep = prep._replace(means2d=_shift_rows(
        prep.means2d, coll.rank_of(group) * band))
    out, _ = _render_band(prep, opacities, settings, band, bg_color)
    bands = coll.all_gather(out.image, group, stacked=True,
                            profiler=profiler)
    return _frame(bands, settings.height)


# ---------------------------------------------------------------------------
# Gaussian-parallel (map-sharded) training (JAX sharding.py:293-558): each
# rank holds a contiguous block of capacity/n rows of the map and of its
# Adam moments. A step preprocesses the rank's rows, gathers the compact
# screen features of all rows (about 12 values a Gaussian, against ~59
# parameters and ~118 moments that stay put), renders the rank's band of
# tile rows, gathers the bands, and computes the full-frame loss on every
# rank (SSIM windows cross the bands). Backward runs through the two
# gathers; Adam is shard-local.
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    per = x.shape[0] // n
    return x[rank * per:(rank + 1) * per].clone()


def shard_gaussian_state(group, state: gm.GaussianState,
                         opt_state: optim.AdamState):
    """This rank's block of rows of a full map (the same full map on every
    rank, e.g. after replicate): every state field and Adam's m and v cut
    to rows [rank * C/n, (rank + 1) * C/n); the step counter is kept (it
    is the same on every rank). Raises unless n divides the capacity
    (gm.round_capacity keeps powers of two)."""
    n, rank = coll.size_of(group), coll.rank_of(group)
    cap = state.capacity
    if cap % n:
        raise ValueError(f"shard_gaussian_state: capacity {cap} over {n} "
                         "ranks")

    def cut(tree):
        return type(tree)(*(_rows(x, rank, n) for x in tree))

    return (gm.GaussianState(cut(state.params),
                             *(_rows(x, rank, n) for x in state[1:])),
            optim.AdamState(m=cut(opt_state.m), v=cut(opt_state.v),
                            step=opt_state.step.clone()))


def gather_gaussian_state(group, state: gm.GaussianState,
                          opt_state: optim.AdamState):
    """The full map from every rank's block (shard_gaussian_state's
    inverse), on every rank: what reading a sharded jax.Array back with
    np.asarray gives."""
    def gather(tree):
        return type(tree)(*(coll.all_gather(x, group) for x in tree))

    return (gm.GaussianState(gather(state.params),
                             *(coll.all_gather(x, group)
                               for x in state[1:])),
            optim.AdamState(m=gather(opt_state.m), v=gather(opt_state.v),
                            step=opt_state.step))


def train_step_gaussian_sharded(
    state: gm.GaussianState,
    opt_state: optim.AdamState,
    cam: CameraMatrices,
    gt_image: torch.Tensor,
    mask: torch.Tensor,
    lrs: optim.LearningRates,
    bg_color: torch.Tensor,
    lambda_dssim: float,
    settings: RenderSettings,
    group,
    profiler=None,
):
    """One optimization step with the map sharded over the ranks of
    `group` (state and opt_state are this rank's blocks; JAX
    sharding.py:343-477). Matches trainer.train_step on the union of the
    blocks, except where a Gaussian's tiles are clipped to
    max_tiles_per_gaussian (the band may clip its rect and keep other
    tiles). Updates the rank's parameters and moments in place. Returns
    (state, opt_state, {"loss", "num_visible", "binning_clipped",
    "binning_overflow"}), the counts summed over the ranks.

    Gradients: the feature gather's backward is a reduce-scatter sum, so
    each rank receives the sum over all bands of its rows' gradients. The
    band gather's backward takes the rank's own band of the image
    cotangent (collectives.gather_replicated): every rank computes the
    same loss from the same gathered image, so every rank's cotangent is
    the same. JAX's band gather transposes to a psum_scatter instead,
    which delivers n copies, and scales the gradients by 1/n
    (sharding.py:432-437); here there is nothing to scale."""
    n, rank = coll.size_of(group), coll.rank_of(group)
    width, height = settings.width, settings.height
    band = band_rows(height, n)
    live = state.live
    dev = live.device
    params = gm.GaussianParams(*(p.detach().requires_grad_(True)
                                 for p in state.params))
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32,
                         device=dev, requires_grad=True)
    scales, quats, opac = gm.activated(params)
    prep = prep_mod.preprocess(
        params.xyz, scales, quats, cam.viewmatrix, cam.full_proj,
        cam.cam_center, width, height, settings.tan_fovx, settings.tan_fovy,
        sh_degree=settings.sh_degree, shs=gm.sh_features(params),
        scale_modifier=settings.scale_modifier, live_mask=live,
        principal=settings.principal)
    # One differentiable gather of the float features (means2d, depth,
    # conic, rgb, opacity: 10 columns) and one of radii and visibility.
    feat = coll.all_gather(torch.cat([
        prep.means2d + offset, prep.depths[:, None], prep.conics, prep.rgb,
        opac[:, None]], dim=-1), group, profiler=profiler)
    rv = coll.all_gather(torch.stack([prep.radii,
                                      prep.visible.to(torch.int32)], -1),
                         group, profiler=profiler)
    gathered = prep_mod.Preprocessed(
        means2d=_shift_rows(feat[:, 0:2], rank * band), depths=feat[:, 2],
        conics=feat[:, 3:6], radii=rv[:, 0], rgb=feat[:, 6:9],
        visible=rv[:, 1].bool())
    out, binning = _render_band(gathered, feat[:, 9], settings, band,
                                bg_color)
    img = _frame(coll.gather_replicated(out.image, group,
                                        profiler=profiler), height)
    masked = img * mask[None]
    loss = losses.training_loss(masked, gt_image, lambda_dssim)
    grads = torch.autograd.grad(loss, [*params, offset], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, [*params, offset])]

    with torch.no_grad():
        # The statistics start from zeros on the shard and combine with
        # the state's as max, +, + (JAX sharding.py:439-445, 468-473).
        cap = state.capacity
        zeros = torch.zeros(cap, dtype=torch.float32, device=dev)
        st = state._replace(max_radii2d=zeros, xyz_grad_accum=zeros,
                            denom=zeros)
        st = dz.update_max_radii(st, prep.radii, prep.visible)
        st = dz.add_densification_stats(st, grads[-1], prep.visible, width,
                                        height)
        new_params, opt_state = optim.adam_step(
            state.params, gm.GaussianParams(*grads[:-1]), opt_state, lrs,
            live)
        counts = coll.all_reduce_sum(torch.stack([
            prep.visible.sum(dtype=torch.int32), binning.num_clipped,
            binning.num_overflow]), group, profiler=profiler)
        state = state._replace(
            params=new_params,
            max_radii2d=torch.maximum(state.max_radii2d, st.max_radii2d),
            xyz_grad_accum=state.xyz_grad_accum + st.xyz_grad_accum,
            denom=state.denom + st.denom)
    return state, opt_state, {"loss": loss.detach(),
                              "num_visible": counts[0],
                              "binning_clipped": counts[1],
                              "binning_overflow": counts[2]}


def densify_step_gaussian_sharded(state: gm.GaussianState,
                                  opt_state: optim.AdamState,
                                  noise: torch.Tensor, extent, *,
                                  grad_threshold: float, min_opacity: float,
                                  max_screen_size: int, percent_dense: float,
                                  group, profiler=None):
    """Densify, clone, split and prune on the rank's block of the map
    (JAX sharding.py:480-528): its own free-slot budget, its own gradient
    ranking, its own split draws `noise` [2, C/n, 3] (JAX folds the rank
    into its key). Clones and split children stay in the parent's block,
    so the event needs no communication but the sum of the counts.
    Returns (state, opt_state, DensifyInfo summed over the ranks)."""
    state, opt_state, info = dz.densify_and_prune(
        state, opt_state, noise, grad_threshold, min_opacity, extent,
        max_screen_size, percent_dense)
    total = coll.all_reduce_sum(torch.stack(list(info)), group,
                                profiler=profiler)
    return state, opt_state, dz.DensifyInfo(*total.unbind())


def deal_gaussian_shards(state: gm.GaussianState, opt_state: optim.AdamState,
                         n_shards: int):
    """Permute the capacity slots so that live and free slots spread
    evenly over the n contiguous blocks: a round-robin deal of the
    live-first order (JAX sharding.py:531-558, the same permutation). A
    shard-local densify budgets against its own block's free slots, and a
    grown or compacted map holds all of them in the last blocks. Slot order
    means nothing to the render (it sorts by depth) or to Adam
    (elementwise), so this is a relabeling. Reads the live mask to the
    host (a rare structural event, like capacity growth)."""
    live = state.live.cpu().numpy()
    cap = live.shape[0]
    if cap % n_shards:
        raise ValueError(f"deal_gaussian_shards: capacity {cap} over "
                         f"{n_shards} shards")
    per = cap // n_shards
    order = np.argsort(~live, kind="stable")       # live rows first
    dest = (np.arange(cap) % n_shards) * per + np.arange(cap) // n_shards
    gather_idx = np.empty(cap, np.int64)
    gather_idx[dest] = order                       # new_row[d] = old[order[i]]
    idx = torch.from_numpy(gather_idx).to(state.live.device)

    def take(tree):
        return type(tree)(*(x[idx] for x in tree))

    return (gm.GaussianState(take(state.params), *(x[idx]
                                                   for x in state[1:])),
            optim.AdamState(m=take(opt_state.m), v=take(opt_state.v),
                            step=opt_state.step))
