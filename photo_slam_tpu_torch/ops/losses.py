"""Image losses and quality metrics: L1, PSNR (2 variants), SSIM.

Counterpart of photo_slam_tpu/ops/losses.py (reference:
include/loss_utils.h:28-125). SSIM uses an 11x11 Gaussian window with
sigma = 1.5 and zero padding of window_size // 2, applied per channel. The
JAX package blurs with banded matmuls (a TPU workaround, losses.py:62-81);
here the blur is a depthwise separable `F.conv2d`, which gives the same
numbers at a fraction of the FLOPs, run with TF32 off (cuDNN's default is
TF32 on). Images are CHW float32 in [0, 1].
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(reference: include/loss_utils.h:28-31)."""
    return (pred - gt).abs().mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean-MSE PSNR (reference: include/loss_utils.h:33-37)."""
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)


def psnr_gaussian_splatting(img1: torch.Tensor,
                            img2: torch.Tensor) -> torch.Tensor:
    """Per-channel PSNR variant used by 3DGS eval
    (reference: include/loss_utils.h:43-47): MSE per leading dim, then the
    mean of 20 log10(1 / sqrt(mse))."""
    c = img1.shape[0]
    mse = ((img1 - img2).reshape(c, -1) ** 2).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    """1D normalized Gaussian (reference: include/loss_utils.h:49-63) on
    `device`, built once: a copy from host memory per call would make every
    training step wait for the card."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return torch.from_numpy((g / g.sum()).astype(np.float32)).to(device)


def _gaussian_blur(img: torch.Tensor, window_size: int,
                   sigma: float) -> torch.Tensor:
    """Separable per-channel Gaussian blur of a CHW image with zero padding:
    a [1, w] then a [w, 1] convolution with the channels as the batch. The
    convolutions run in full float32 (TF32 off) inside a local cuDNN flags
    context; the global flags are left as they were."""
    w = _gaussian_window(window_size, sigma, img.device)
    pad = window_size // 2
    x = img[:, None]                                   # [C, 1, H, W]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        x = F.conv2d(x, w.view(1, 1, 1, -1), padding=(0, pad))
        x = F.conv2d(x, w.view(1, 1, -1, 1), padding=(pad, 0))
    return x[:, 0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """SSIM over CHW images (reference: include/loss_utils.h:76-124).
    Returns the scalar mean SSIM; differentiable (the training loss uses
    1 - ssim)."""
    def blur(x):
        return _gaussian_blur(x, window_size, sigma)

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2

    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def training_loss(pred: torch.Tensor, gt: torch.Tensor,
                  lambda_dssim: float) -> torch.Tensor:
    """(1-λ)·L1 + λ·(1-SSIM) (reference: src/gaussian_mapper.cpp:695-698)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))
