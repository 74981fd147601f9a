"""The reference against the program's plain path (its CPU route) at a tiny
size: the same image, the same loss and the same gradients, and the
control's TF32 rounding."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import byname, cells, scenes
from port_bench.reference import camera as rcam
from port_bench.reference import render as rren
from port_bench.reference import train as rtrain

REPO = Path(__file__).resolve().parents[2]
CAM = {"width": 96, "height": 64, "fx": 80.0, "fy": 80.0, "cx": 47.5,
       "cy": 31.5}
MAP = {"kind": "room", "gaussians": 3000, "sh_degree": 3, "scale": 0.15,
       "scale_spread": 0.25, "opacity": [0.3, 0.95], "sh_rest": 0.05}
CFG = {"camera": CAM, "map": MAP, "caps": {"k_dup": 6, "max_per_tile": 64}}


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(2)
    params = scenes.make_map(REPO, MAP, torch.Generator().manual_seed(11),
                             "cpu")
    q, t = byname.module(REPO, "views", "bench").views({}, None)[5]
    return params, q, t


def program_render(params, q, t):
    from photo_slam_tpu_torch.models import gaussian_model as gm
    from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
    from photo_slam_tpu_torch.ops.render import (RenderSettings,
                                                 principal_for, render)

    cam = cells.program_camera(CAM)
    R = rcam.rotation_of(q)
    mats = build_camera_matrices(R, t, 0.01, 100.0, cam.fovx, cam.fovy,
                                 device="cpu")
    s = RenderSettings(width=96, height=64,
                       tan_fovx=float(np.tan(0.5 * cam.fovx)),
                       tan_fovy=float(np.tan(0.5 * cam.fovy)), sh_degree=3,
                       max_tiles_per_gaussian=6, max_per_tile=64,
                       principal=principal_for(cam, 96, 64))
    state = cells.program_state(params, "cpu")
    sc, qu, op = gm.activated(state.params)
    return render(state.params.xyz, sc, qu, op, mats, s, torch.zeros(3),
                  shs=gm.sh_features(state.params), live_mask=state.live)


def test_render_equals_the_programs_plain_path(scene):
    params, q, t = scene
    s, fovx, fovy = cells.view_settings(CFG)
    mats = rcam.matrices(rcam.rotation_of(q), t, 0.01, 100.0, fovx, fovy,
                         "cpu")
    ref = rren.render(params, mats, s, torch.zeros(3)).image
    prog = program_render(params, q, t).image
    assert float(ref.abs().max()) > 0.05
    assert torch.equal(ref, prog)


def test_training_gradient_equals_the_programs(scene):
    from photo_slam_tpu_torch.ops import losses

    params, q, t = scene
    s, fovx, fovy = cells.view_settings(CFG)
    mats = rcam.matrices(rcam.rotation_of(q), t, 0.01, 100.0, fovx, fovy,
                         "cpu")
    gt = torch.rand((3, 64, 96), generator=torch.Generator().manual_seed(2))
    mask = torch.ones(64, 96)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = rtrain.loss_of(rren.render(leaves, mats, s, torch.zeros(3))
                          .image, gt, mask, 0.2, "f32")
    ref = torch.autograd.grad(loss, [leaves[k] for k in rtrain.GROUPS])

    prog_leaves = {k: v.clone().requires_grad_(True)
                   for k, v in params.items()}
    img = program_render(prog_leaves, q, t).image
    prog_loss = losses.training_loss(img, gt, 0.2)
    prog = torch.autograd.grad(prog_loss, [prog_leaves[k]
                                           for k in rtrain.GROUPS])
    assert float(loss.detach()) == float(prog_loss.detach())
    for k, a, b in zip(rtrain.GROUPS, ref, prog):
        scale = float(b.abs().max())
        assert scale > 0, k
        assert float((a - b).abs().max()) <= 1e-6 * scale, k


def test_adam_and_learning_rate_equal_the_programs():
    from photo_slam_tpu_torch.models import gaussian_model as gm
    from photo_slam_tpu_torch.models import optimizer as optim

    g = torch.Generator().manual_seed(5)
    params = {k: torch.randn((7, 3), generator=g) for k in rtrain.GROUPS}
    grads = {k: torch.randn((7, 3), generator=g) for k in rtrain.GROUPS}
    opt = {"position_lr_init": 0.00016, "position_lr_final": 1.6e-6,
           "position_lr_delay_mult": 0.01, "position_lr_max_steps": 30000,
           "feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
           "rotation_lr": 0.001}
    lrs = rtrain.learning_rates(opt, 15001, 3.7)
    pos = optim.expon_lr(15001, 0.00016 * 3.7, 1.6e-6 * 3.7,
                         lr_delay_mult=0.01, max_steps=30000)
    prog_lrs = optim.LearningRates.create(pos, 0.0025, 0.05, 0.005, 0.001)
    assert lrs == prog_lrs._asdict()
    prog = gm.GaussianParams(**{k: v.clone() for k, v in params.items()})
    state = optim.init_adam(prog)
    ref = {k: v.clone() for k, v in params.items()}
    adam = rtrain.Adam(ref)
    for _ in range(3):
        optim.adam_step(prog, gm.GaussianParams(**grads), state, prog_lrs,
                        torch.ones(7, dtype=torch.bool))
        adam.update(ref, grads, lrs)
    for k in rtrain.GROUPS:
        assert torch.allclose(ref[k], getattr(prog, k), rtol=0, atol=1e-7)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10,
                      -3.0, float("inf")])
    assert rcam.tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10,
                                     -3.0, float("inf")]
