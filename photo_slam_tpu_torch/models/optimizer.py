"""Sparse masked Adam over the Gaussian parameter groups + LR schedules.

Counterpart of photo_slam_tpu/models/optimizer.py (reference:
src/gaussian_model.cpp:477-554): six parameter groups with their own
learning rates, eps = 1e-15, betas (0.9, 0.999), one shared step counter,
dead slots frozen. Densify and prune "optimizer surgery" is zeroing the
moments at the affected slots. The state is a NamedTuple of tensors on the
map's device; the step counter is a 0-d int32 tensor there, so no step
reads anything back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.models.gaussian_model import GaussianParams

ADAM_EPS = 1e-15
BETA1 = 0.9
BETA2 = 0.999

# Parameter-group order (reference: src/gaussian_model.cpp:460-466).
GROUPS = GaussianParams._fields


class LearningRates(NamedTuple):
    """Per-group learning rates: Python floats, or 0-d float32 tensors on
    the map's device holding the same values (lr_tensors), which a captured
    step reads at each replay."""

    xyz: float
    features_dc: float
    features_rest: float
    opacity_logit: float
    log_scales: float
    quats: float

    @staticmethod
    def create(position_lr, feature_lr, opacity_lr, scaling_lr, rotation_lr):
        """features_rest always runs at feature_lr / 20
        (reference: src/gaussian_model.cpp:494-496)."""
        f = np.float32
        return LearningRates(
            xyz=float(f(position_lr)),
            features_dc=float(f(feature_lr)),
            features_rest=float(f(feature_lr) / f(20.0)),
            opacity_logit=float(f(opacity_lr)),
            log_scales=float(f(scaling_lr)),
            quats=float(f(rotation_lr)),
        )


def lr_tensors(device) -> LearningRates:
    """0-d float32 tensors on `device`, one per group, for set_lrs to fill:
    the learning rates a captured train step reads, as JAX passes `lrs` as
    traced arrays so that its jit does not recompile for them."""
    return LearningRates(*(torch.zeros((), dtype=torch.float32,
                                       device=device)
                           for _ in LearningRates._fields))


def set_lrs(dst: LearningRates, lrs: LearningRates) -> None:
    """Fill the tensors of `dst` (lr_tensors) with the float learning rates
    `lrs`, float32 as a Python float times a float32 tensor rounds them.
    Each write is a fill kernel: nothing waits for the device."""
    for t, x in zip(dst, lrs):
        t.fill_(x)


class AdamState(NamedTuple):
    m: GaussianParams
    v: GaussianParams
    step: torch.Tensor  # 0-d int32, on the moments' device


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(
        m=GaussianParams(*(torch.zeros_like(p) for p in params)),
        v=GaussianParams(*(torch.zeros_like(p) for p in params)),
        step=torch.zeros((), dtype=torch.int32, device=params.xyz.device),
    )


def adam_from_numpy(m: dict[str, np.ndarray], v: dict[str, np.ndarray],
                    step, *, device) -> AdamState:
    """Carry an Adam state across from numpy arrays (e.g. a JAX AdamState's
    m and v under their GaussianParams names, and its step)."""
    def group(arrs):
        return GaussianParams(**{
            k: torch.from_numpy(np.array(arrs[k], np.float32)).to(device)
            for k in GROUPS})

    return AdamState(m=group(m), v=group(v),
                     step=torch.tensor(int(step), dtype=torch.int32,
                                       device=device))


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (x.dim() - 1))


def adam_step(params: GaussianParams, grads: GaussianParams,
              opt_state: AdamState, lrs: LearningRates,
              live: torch.Tensor) -> tuple[GaussianParams, AdamState]:
    """One Adam update over all live Gaussians, IN PLACE: the parameter and
    moment tensors and the step count are overwritten (the JAX step donates
    the same buffers) and returned. Dead slots are frozen; their gradients
    are zeroed first, which also guards against NaN poisoning. The bias
    corrections are float32, as in JAX. `lrs` holds floats or 0-d float32
    tensors (lr_tensors); both give the same update."""
    step = opt_state.step
    step.add_(1)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(BETA1, t)
    bc2 = 1.0 - torch.pow(BETA2, t)
    with torch.no_grad():
        for name, p, g, m, v in zip(GROUPS, params, grads, opt_state.m,
                                    opt_state.v):
            mask = _bcast(live, p)
            g = torch.where(mask, g, 0.0)
            m.copy_(BETA1 * m + (1.0 - BETA1) * g)
            v.copy_(BETA2 * v + (1.0 - BETA2) * (g * g))
            update = getattr(lrs, name) * (m / bc1) / (
                torch.sqrt(v / bc2) + ADAM_EPS)
            p.copy_(torch.where(mask, p - update, p))
    return params, opt_state._replace(step=step)


def zero_moments_at(opt_state: AdamState, slots: torch.Tensor,
                    mask: torch.Tensor) -> AdamState:
    """Zero the moments at `slots` where `mask`: the surgery for newly
    created Gaussians (cat with zeros in the reference)."""
    cap = opt_state.m.xyz.shape[0]
    hits = torch.zeros(cap, dtype=torch.int32, device=slots.device)
    hits.index_add_(0, slots.long(), mask.to(torch.int32))
    return zero_moments_where(opt_state, hits > 0)


def zero_moments_where(opt_state: AdamState, mask: torch.Tensor,
                       group: str | None = None) -> AdamState:
    """Zero the moments at every slot where `mask`; only one group's when
    `group` is given (resetOpacity zeroes just the opacity group's,
    reference: src/gaussian_model.cpp:556-586)."""
    def z(name, x):
        if group is not None and name != group:
            return x
        return torch.where(_bcast(mask, x), 0.0, x)

    return AdamState(
        m=GaussianParams(*(z(n, x) for n, x in zip(GROUPS, opt_state.m))),
        v=GaussianParams(*(z(n, x) for n, x in zip(GROUPS, opt_state.v))),
        step=opt_state.step)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000) -> float:
    """Log-lerp LR schedule with an optional sine delay ramp
    (reference: src/gaussian_model.cpp:1118-1131), in float32 on the host
    as the JAX package computes it."""
    f = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = f(step)
    if lr_delay_steps > 0:
        delay_rate = f(lr_delay_mult) + f(1.0 - lr_delay_mult) * np.sin(
            f(0.5 * np.pi) * np.clip(step / f(lr_delay_steps), f(0), f(1)))
    else:
        delay_rate = f(1.0)
    t = np.clip(step / f(max_steps), f(0.0), f(1.0))
    log_lerp = np.exp(np.log(f(lr_init)) * (f(1.0) - t)
                      + np.log(f(lr_final)) * t)
    lr = f(delay_rate * log_lerp)
    return 0.0 if step < 0 else float(lr)
