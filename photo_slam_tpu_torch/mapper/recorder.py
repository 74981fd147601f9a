"""Per-keyframe quality recording: dssim / psnr / psnr_gs / render_time files.

Counterpart of photo_slam_tpu/mapper/recorder.py: the artifact set of the
reference's renderAndRecordAllKeyframes (reference:
src/gaussian_mapper.cpp:1571-1656), per-keyframe metric text files plus
optional rendered / ground-truth / loss images under the same names, so the
Photo-SLAM-eval tooling runs unchanged. Renders go through the kernel path,
overflow-exact (cfg.renderer.record_overflow_passes continuation passes),
replayed from captured graphs (ops/render.render_jit).
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.ops import losses
from photo_slam_tpu_torch.ops.render import (RenderSettings, principal_for,
                                             render_jit)


def render_keyframe(mapper, kf) -> torch.Tensor:
    """Render one keyframe at full resolution from the current map, on the
    mapper's device."""
    cam = kf.camera
    r = mapper.cfg.renderer
    k_dup, per_tile = r.caps_for_mode("pallas")
    settings = RenderSettings(
        width=cam.width, height=cam.height,
        tan_fovx=float(np.tan(cam.fovx / 2)),
        tan_fovy=float(np.tan(cam.fovy / 2)),
        principal=principal_for(cam, cam.width, cam.height),
        sh_degree=mapper.trainer.default_sh,
        max_tiles_per_gaussian=k_dup,
        max_per_tile=per_tile,
        # Recorded metrics are the run's quality artifacts: render them
        # overflow-exact (continuation passes cost only where tiles
        # overflow).
        overflow_passes=r.record_overflow_passes,
        mode="pallas")
    state = mapper.trainer.state
    scales, quats, opac = gm.activated(state.params)
    with torch.no_grad():
        return render_jit(state.params.xyz, scales, quats, opac,
                          kf.matrices, settings, mapper.trainer.bg_color,
                          shs=gm.sh_features(state.params),
                          live_mask=state.live).image


def render_and_record_keyframes(mapper, out_dir, suffix: str = "") -> dict:
    """Render every keyframe with an image, write the metric files under
    out_dir (and the images the record config asks for); returns the mean
    of each metric."""
    out = Path(out_dir)
    rec = mapper.cfg.record
    device = mapper.trainer.device
    metrics = {"dssim": [], "psnr": [], "psnr_gs": [], "render_time_ms": []}
    files = {k: [] for k in metrics}

    for fid, kf in sorted(mapper.scene.keyframes.items()):
        if kf.image is None or kf.matrices is None:
            continue
        t0 = time.time()
        img = render_keyframe(mapper, kf)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt_ms = (time.time() - t0) * 1000.0
        mask = torch.from_numpy(kf.camera.undistort_mask()).to(device)
        masked = img * mask[None]
        gt = torch.from_numpy(kf.image).to(device)
        dssim = float(1.0 - losses.ssim(masked, gt))
        p = float(losses.psnr(masked, gt))
        pgs = float(losses.psnr_gaussian_splatting(masked, gt))
        metrics["dssim"].append(dssim)
        metrics["psnr"].append(p)
        metrics["psnr_gs"].append(pgs)
        metrics["render_time_ms"].append(dt_ms)
        files["dssim"].append(f"{fid} {dssim:.6f}")
        files["psnr"].append(f"{fid} {p:.6f}")
        files["psnr_gs"].append(f"{fid} {pgs:.6f}")
        files["render_time_ms"].append(f"{fid} {dt_ms:.3f}")

        if (rec.record_rendered_image or rec.record_ground_truth_image
                or rec.record_loss_image):
            from photo_slam_tpu_torch.io.images import save_image_chw
            host = masked.cpu().numpy()
            if rec.record_rendered_image:
                save_image_chw(out / "image_rendered" / f"{fid}{suffix}.png",
                               host)
            if rec.record_ground_truth_image:
                save_image_chw(out / "image_gt" / f"{fid}{suffix}.png",
                               kf.image)
            if rec.record_loss_image:
                save_image_chw(out / "image_loss" / f"{fid}{suffix}.png",
                               np.abs(host - kf.image))

    out.mkdir(parents=True, exist_ok=True)
    name_map = {"dssim": "dssim.txt", "psnr": "psnr.txt",
                "psnr_gs": "psnr_gaussian_splatting.txt",
                "render_time_ms": "render_time.txt"}
    for k, fname in name_map.items():
        (out / (fname.replace(".txt", suffix + ".txt") if suffix else fname)
         ).write_text("\n".join(files[k]) + "\n")

    return {k: (float(np.mean(v)) if v else float("nan"))
            for k, v in metrics.items()}
