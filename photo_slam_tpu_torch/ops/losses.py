"""Image metrics: L1 and PSNR.

Counterpart of the first half of photo_slam_tpu/ops/losses.py (reference:
include/loss_utils.h:28-37); SSIM comes with the training slice. Images are
CHW float32 in [0, 1].
"""
from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(reference: include/loss_utils.h:28-31)."""
    return (pred - gt).abs().mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean-MSE PSNR (reference: include/loss_utils.h:33-37)."""
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)
