"""The training iteration in plain PyTorch: render, masked (1 - lambda) L1 +
lambda (1 - SSIM), autograd, and Adam over the six parameter groups (eps
1e-15, betas 0.9 and 0.999, one step count, bias corrections in float32),
with the exponential position learning rate."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.camera import Matrices, tf32
from port_bench.reference.render import Settings, render

GROUPS = ("xyz", "features_dc", "features_rest", "opacity_logit",
          "log_scales", "quats")
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15


def expon_lr(step, lr_init: float, lr_final: float, delay_mult: float,
             max_steps: int) -> float:
    """Log-linear interpolation from lr_init to lr_final over max_steps, in
    float32 on the host (no delay ramp: the trainer uses none)."""
    f = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    t = np.clip(f(step) / f(max_steps), f(0.0), f(1.0))
    lr = f(f(1.0) * np.exp(np.log(f(lr_init)) * (f(1.0) - t)
                           + np.log(f(lr_final)) * t))
    return float(lr)


def learning_rates(opt: dict, iteration: int, spatial_scale: float) -> dict:
    """Each group's rate at `iteration` (1-based) for the configuration's
    `opt` block; features_rest at feature_lr / 20."""
    f = np.float32
    pos = expon_lr(min(iteration, opt["position_lr_max_steps"]),
                   opt["position_lr_init"] * spatial_scale,
                   opt["position_lr_final"] * spatial_scale,
                   opt["position_lr_delay_mult"],
                   opt["position_lr_max_steps"])
    return {"xyz": float(f(pos)),
            "features_dc": float(f(opt["feature_lr"])),
            "features_rest": float(f(opt["feature_lr"]) / f(20.0)),
            "opacity_logit": float(f(opt["opacity_lr"])),
            "log_scales": float(f(opt["scaling_lr"])),
            "quats": float(f(opt["rotation_lr"]))}


def blur(img: torch.Tensor, prec: str, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Per-channel separable Gaussian blur with zero padding."""
    xs = np.arange(window) - window // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    w = torch.from_numpy((g / g.sum()).astype(np.float32)).to(img.device)
    x = img[:, None]
    if prec == "tf32":
        x, w = tf32(x), tf32(w)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        x = F.conv2d(x, w.view(1, 1, 1, -1), padding=(0, window // 2))
        if prec == "tf32":
            x = tf32(x)
        x = F.conv2d(x, w.view(1, 1, -1, 1), padding=(window // 2, 0))
    return x[:, 0]


def ssim(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    mu1, mu2 = blur(a, prec), blur(b, prec)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(a * a, prec) - mu1_sq
    s2 = blur(b * b, prec) - mu2_sq
    s12 = blur(a * b, prec) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2.0 * mu12 + c1) * (2.0 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))).mean()


def loss_of(image, gt, mask, lambda_dssim: float, prec: str):
    pred = image * mask[None, :, :]
    return ((1.0 - lambda_dssim) * (pred - gt).abs().mean()
            + lambda_dssim * (1.0 - ssim(pred, gt, prec)))


class Adam:
    """Adam's moments and step count over the six groups."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step = 0

    def update(self, params: dict, grads: dict, lrs: dict) -> None:
        self.step += 1
        t = torch.tensor(float(self.step), dtype=torch.float32)
        bc1 = float(1.0 - torch.pow(torch.tensor(BETA1), t))
        bc2 = float(1.0 - torch.pow(torch.tensor(BETA2), t))
        with torch.no_grad():
            for k in GROUPS:
                g, m, v = grads[k], self.m[k], self.v[k]
                m.mul_(BETA1).add_((1.0 - BETA1) * g)
                v.mul_(BETA2).add_((1.0 - BETA2) * (g * g))
                params[k].sub_(lrs[k] * (m / bc1)
                               / (torch.sqrt(v / bc2) + ADAM_EPS))


def train_step(params: dict, adam: Adam, cam: Matrices, gt, mask,
               s: Settings, bg, lambda_dssim: float, lrs: dict,
               prec: str = "f32") -> float:
    """One iteration on `params` (written in place). Returns the loss."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in GROUPS}
    frame = render(leaves, cam, s, bg, prec)
    loss = loss_of(frame.image, gt, mask, lambda_dssim, prec)
    grads = torch.autograd.grad(loss, [leaves[k] for k in GROUPS],
                                allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(GROUPS, grads)}
    adam.update(params, grads, lrs)
    return float(loss.detach())
