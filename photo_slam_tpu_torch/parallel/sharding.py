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

The multi-process half (data parallelism over torch.distributed,
render_image_sharded, the Gaussian-sharded step and densify,
deal_gaussian_shards) is not ported yet.
"""
from __future__ import annotations

import contextlib

import torch

from photo_slam_tpu_torch.models import densify as dz
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops import losses
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.render import RenderSettings, render


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
):
    """One multi-view optimization step (B views, mean gradient), the B
    views one after the other on the state's device, then one shared Adam
    update written in place. `lock` (a context manager, e.g. the mapper's
    render lock) is held around the state writes: the densification
    statistics and Adam. Returns (state, opt_state, {"loss", "num_visible"})
    with 0-d tensors."""
    offset0 = torch.zeros((state.capacity, 2), dtype=torch.float32,
                          device=state.live.device)
    b = gt_images.shape[0]
    loss_s, grads_s, g2d_s, visible, radii = _accumulate_view_grads(
        state.params, state.live, offset0, cams, gt_images, masks, bg_color,
        lambda_dssim, settings)
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
