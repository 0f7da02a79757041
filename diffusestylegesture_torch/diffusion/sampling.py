"""Reverse-process samplers as Python loops over the timestep grid.

Port of `diffusestylegesture_tpu/diffusion/sampling.py` (reference
`gaussian_diffusion.py:506-1087`, `cfg_sampler.py`): ancestral DDPM, DDIM,
PLMS and DPM-Solver++(2M), each calling ``model_fn(x, t)`` once per step
(PLMS twice on its first step) with ORIGINAL-schedule timesteps
(``sched.timestep_map[t]``). Randomness comes from an explicit
`torch.Generator`; ``noise=`` injects x_T so two implementations can be
driven from identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import gaussian as G
from .schedule import Schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    mean_type: G.MeanType = G.MeanType.START_X
    var_type: G.VarType = G.VarType.FIXED_SMALL
    clip_denoised: bool = False
    const_noise: bool = False
    eta: float = 0.0  # DDIM
    order: int = 2  # PLMS


def _tvec(sched: Schedule, i: int, batch: int) -> torch.Tensor:
    return torch.full((batch,), i, dtype=torch.long, device=sched.device)


def _model_and_stats(sched, model_fn, x, t, cfg: SamplerConfig) -> G.PMeanVariance:
    model_output = model_fn(x, sched.timestep_map[t])
    return G.p_mean_variance(sched, model_output, x, t, mean_type=cfg.mean_type,
                             var_type=cfg.var_type, clip_denoised=cfg.clip_denoised)


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def _init_img(sched, shape, generator, noise, skip_timesteps, init_image):
    """Initial x_T (+ warm start by q-sampling the init image to t0, ref `:700-713`)."""
    img = _randn(shape, generator, sched.device) if noise is None else noise
    t0 = sched.num_timesteps - skip_timesteps - 1
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(tuple(shape), device=sched.device)
    if init_image is not None:
        img = G.q_sample(sched, init_image, _tvec(sched, t0, shape[0]), img)
    return img, t0


def p_sample_loop(sched: Schedule, model_fn: ModelFn, shape,
                  generator: Optional[torch.Generator] = None, *,
                  cfg: SamplerConfig = SamplerConfig(),
                  noise: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                  init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral DDPM (ref `p_sample_loop:608`)."""
    img, t0 = _init_img(sched, shape, generator, noise, skip_timesteps, init_image)
    for i in range(t0, -1, -1):
        t = _tvec(sched, i, shape[0])
        out = _model_and_stats(sched, model_fn, img, t, cfg)
        if i == 0:  # the reference masks the noise at t=0
            img = out.mean
            continue
        z = _randn(shape, generator, sched.device)
        if cfg.const_noise:
            z = z[:1].expand(tuple(shape))
        img = out.mean + torch.exp(0.5 * out.log_variance) * z
    return img


def ddim_sample_loop(sched: Schedule, model_fn: ModelFn, shape,
                     generator: Optional[torch.Generator] = None, *,
                     cfg: SamplerConfig = SamplerConfig(),
                     noise: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                     init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM with eta (ref `ddim_sample:742`)."""
    img, t0 = _init_img(sched, shape, generator, noise, skip_timesteps, init_image)
    nd = len(shape)
    for i in range(t0, -1, -1):
        t = _tvec(sched, i, shape[0])
        out = _model_and_stats(sched, model_fn, img, t, cfg)
        eps = G.predict_eps_from_xstart(sched, img, t, out.pred_xstart)
        alpha_bar = G._bcast(sched.alphas_cumprod, t, nd)
        alpha_bar_prev = G._bcast(sched.alphas_cumprod_prev, t, nd)
        sigma = (cfg.eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        img = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
               + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        if cfg.eta and i > 0:
            img = img + sigma * _randn(shape, generator, sched.device)
    return img


_AB = (
    (1.0,),
    (3.0 / 2.0, -1.0 / 2.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


def plms_sample_loop(sched: Schedule, model_fn: ModelFn, shape,
                     generator: Optional[torch.Generator] = None, *,
                     cfg: SamplerConfig = SamplerConfig(),
                     noise: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                     init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PLMS / Adams–Bashforth (ref `plms_sample:1005-1087`): the order ramps
    1 → `cfg.order` as the eps history fills; for order > 1 the first step
    is the reference's pseudo improved-Euler double evaluation."""
    order = int(cfg.order)
    if not 1 <= order <= 4:
        raise ValueError("order must be in [1, 4]")
    img, t0 = _init_img(sched, shape, generator, noise, skip_timesteps, init_image)
    nd = len(shape)
    hist = []  # previous eps, newest first, at most order - 1 of them

    def get_eps(x, t):
        out = _model_and_stats(sched, model_fn, x, t, cfg)
        return G.predict_eps_from_xstart(sched, x, t, out.pred_xstart), out

    for i in range(t0, -1, -1):
        t = _tvec(sched, i, shape[0])
        alpha_bar_prev = G._bcast(sched.alphas_cumprod_prev, t, nd)
        eps, out = get_eps(img, t)
        if order == 1:
            eps_prime = eps
        elif not hist:
            mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev) * eps)
            eps2, _ = get_eps(mean_pred, _tvec(sched, max(i - 1, 0), shape[0]))
            eps_prime = (eps + eps2) / 2.0
        else:
            h = [eps] + hist
            coef = _AB[len(h) - 1]
            eps_prime = coef[0] * h[0]
            for c, e in zip(coef[1:], h[1:]):
                eps_prime = eps_prime + c * e
        pred_prime = G.predict_xstart_from_eps(sched, img, t, eps_prime)
        mean_pred = (pred_prime * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev) * eps_prime)
        img = mean_pred if i > 0 else out.pred_xstart
        hist = ([eps] + hist)[: order - 1]
    return img


def dpmpp2m_sample_loop(sched: Schedule, model_fn: ModelFn, shape,
                        generator: Optional[torch.Generator] = None, *,
                        cfg: SamplerConfig = SamplerConfig(),
                        noise: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                        init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022), data-prediction multistep form over
    the schedule's own grid t0 → 0; the last step to σ = 0 is first order
    and returns the model's x0 prediction at grid point 0."""
    img, t0 = _init_img(sched, shape, generator, noise, skip_timesteps, init_image)
    alpha = torch.sqrt(sched.alphas_cumprod)
    sigma = torch.sqrt(1.0 - sched.alphas_cumprod)
    lam = torch.log(alpha) - torch.log(sigma)

    def x0_at(x, i):
        return _model_and_stats(sched, model_fn, x, _tvec(sched, i, shape[0]), cfg).pred_xstart

    x0_prev, h_prev = None, None
    for i in range(t0, 0, -1):
        j = i - 1
        h = lam[j] - lam[i]
        x0 = x0_at(img, i)
        if x0_prev is None:
            d = x0
        else:
            r = h_prev / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        img = (sigma[j] / sigma[i]) * img - alpha[j] * (torch.exp(-h) - 1.0) * d
        x0_prev, h_prev = x0, h
    return x0_at(img, 0)


def cfg_combine(out_cond: torch.Tensor, out_uncond: torch.Tensor, scale) -> torch.Tensor:
    """Classifier-free guidance mix (`main/model/cfg_sampler.py:25-31`)."""
    return out_uncond + scale * (out_cond - out_uncond)


def make_cfg_model_fn(model_apply, scale, batch_size: int, *, params=None,
                      cond=None) -> Callable:
    """CFG model_fn: the cond and uncond passes run as one doubled batch.

    Bare form ``model_apply(x, t, uncond_mask)``; engine form (``params``
    and ``cond`` given) ``model_apply(params, x, t, cond, uncond=mask)``
    with every conditioning tensor doubled along the batch axis.
    """
    B = batch_size
    cond2 = None if cond is None else {k: torch.cat([v, v], 0) for k, v in cond.items()}

    def fn(x, t):
        x2 = torch.cat([x, x], 0)
        t2 = torch.cat([t, t], 0)
        uncond = torch.cat([torch.zeros(B, dtype=torch.bool, device=x.device),
                            torch.ones(B, dtype=torch.bool, device=x.device)])
        if cond2 is None:
            out = model_apply(x2, t2, uncond)
        else:
            out = model_apply(params, x2, t2, cond2, uncond=uncond)
        return cfg_combine(out[:B], out[B:], scale)

    return fn
