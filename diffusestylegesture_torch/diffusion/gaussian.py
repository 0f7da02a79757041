"""Gaussian diffusion math for sampling, as functions over a `Schedule`.

Port of the sampling subset of `diffusestylegesture_tpu/diffusion/
gaussian.py` (reference `main/diffusion/gaussian_diffusion.py:219-398`):
q_sample, the posterior, the `predict_*` conversions and p_mean_variance.
Training losses come with the training slice.
"""
from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional

import torch

from .schedule import Schedule


class MeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"
    VELOCITY = "velocity"


class VarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, broadcast to an x-shaped rank
    (`_extract_into_tensor`, `gaussian_diffusion.py:1607-1619`)."""
    out = table[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_sample(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sample q(x_t | x_0) with explicit noise (ref `:236-254`)."""
    nd = x_start.ndim
    return (_bcast(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + _bcast(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def q_posterior_mean_variance(sched: Schedule, x_start: torch.Tensor,
                              x_t: torch.Tensor, t: torch.Tensor):
    """q(x_{t-1} | x_t, x_0) (ref `:256-278`)."""
    nd = x_t.ndim
    posterior_mean = (_bcast(sched.posterior_mean_coef1, t, nd) * x_start
                      + _bcast(sched.posterior_mean_coef2, t, nd) * x_t)
    posterior_variance = _bcast(sched.posterior_variance, t, nd)
    posterior_log_variance = _bcast(sched.posterior_log_variance_clipped, t, nd)
    return posterior_mean, posterior_variance, posterior_log_variance


def predict_xstart_from_eps(sched: Schedule, x_t, t, eps):
    nd = x_t.ndim
    return (_bcast(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _bcast(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_xstart_from_xprev(sched: Schedule, x_t, t, xprev):
    nd = x_t.ndim
    return (_bcast(1.0 / sched.posterior_mean_coef1, t, nd) * xprev
            - _bcast(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, nd) * x_t)


def predict_eps_from_xstart(sched: Schedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return ((_bcast(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
            / _bcast(sched.sqrt_recipm1_alphas_cumprod, t, nd))


def predict_xstart_from_v(sched: Schedule, x_t, t, v):
    """x_0 = sqrt(a-bar_t) x_t - sqrt(1 - a-bar_t) v."""
    nd = x_t.ndim
    return (_bcast(sched.sqrt_alphas_cumprod, t, nd) * x_t
            - _bcast(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v)


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance(
    sched: Schedule,
    model_output: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: MeanType = MeanType.START_X,
    var_type: VarType = VarType.FIXED_SMALL,
    clip_denoised: bool = False,
    denoised_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> PMeanVariance:
    """p(x_{t-1} | x_t) statistics from an evaluated model prediction
    (ref `gaussian_diffusion.py:280-398`)."""
    nd = x.ndim

    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        C = x.shape[1]
        model_output, model_var_values = torch.split(
            model_output, [C, model_output.shape[1] - C], dim=1)
        if var_type == VarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = _bcast(sched.posterior_log_variance_clipped, t, nd)
            max_log = _bcast(sched.log_betas, t, nd)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif var_type == VarType.FIXED_LARGE:
        model_variance = _bcast(sched.fixed_large_variance, t, nd)
        model_log_variance = _bcast(sched.fixed_large_log_variance, t, nd)
    else:  # FIXED_SMALL
        model_variance = _bcast(sched.posterior_variance, t, nd)
        model_log_variance = _bcast(sched.posterior_log_variance_clipped, t, nd)

    def process_xstart(xs):
        if denoised_fn is not None:
            xs = denoised_fn(xs)
        if clip_denoised:
            xs = xs.clamp(-1.0, 1.0)
        return xs

    if mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        model_mean = model_output
    else:
        if mean_type == MeanType.START_X:
            pred_xstart = process_xstart(model_output)
        elif mean_type == MeanType.EPSILON:
            pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_output))
        elif mean_type == MeanType.VELOCITY:
            pred_xstart = process_xstart(predict_xstart_from_v(sched, x, t, model_output))
        else:
            raise NotImplementedError(mean_type)
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)

    return PMeanVariance(model_mean, model_variance, model_log_variance, pred_xstart)
