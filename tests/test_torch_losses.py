"""The port's image losses (photo_slam_tpu_torch/ops/losses.py) against the
JAX package's on identical images: SSIM's value and its gradient with
respect to the rendered image, the training loss and the 3DGS PSNR."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.ops import losses as jl
from photo_slam_tpu_torch.ops import losses as tl
from test_torch_blend import one_torch_thread  # noqa: F401


def image_pair(h, w, seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(3, h, w).astype(np.float32)
    # A blurred, shifted copy plus noise: structured but not identical.
    b = np.clip(0.6 * np.roll(a, 2, axis=2) + 0.4 * rng.rand(3, h, w), 0, 1)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("h,w,seed", [(48, 64, 0), (37, 29, 1)])
def test_ssim_value_and_gradient_match_jax(h, w, seed):
    a, b = image_pair(h, w, seed)
    j_val, j_grad = jax.value_and_grad(jl.ssim)(jnp.asarray(a),
                                                jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    t_val = tl.ssim(ta, torch.from_numpy(b))
    t_val.backward()
    assert abs(t_val.item() - float(j_val)) <= 1e-5
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(j_grad),
                               atol=1e-5, rtol=0)
    # The blur leaves cuDNN's global flags as they were.
    assert torch.backends.cudnn.allow_tf32 is True


def test_training_loss_and_psnrs_match_jax():
    a, b = image_pair(48, 64, 2)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for lam in (0.0, 0.2, 1.0):
        assert abs(float(tl.training_loss(ta, tb, lam))
                   - float(jl.training_loss(ja, jb, lam))) <= 1e-5
    assert abs(float(tl.psnr_gaussian_splatting(ta, tb))
               - float(jl.psnr_gaussian_splatting(ja, jb))) <= 1e-5
    assert abs(float(tl.psnr(ta, tb)) - float(jl.psnr(ja, jb))) <= 1e-5
    # Identical images: SSIM 1 on both sides.
    assert abs(float(tl.ssim(ta, ta)) - 1.0) <= 1e-5
