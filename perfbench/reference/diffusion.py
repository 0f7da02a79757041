"""Gaussian diffusion as the reference repository runs it (`main/diffusion/
gaussian_diffusion.py`, `respace.py`): the cosine schedule over 1000 steps,
its `ddimN` respacing, ancestral DDPM with the fixed-small variance and an x0
prediction (`p_sample_loop`), and DPM-Solver++(2M) in its data-prediction
multistep form (Lu et al. 2022) over a respaced grid.

The noise comes from a `torch.Generator` the caller seeds: x_T first, then
one draw after each model call but the last (DDPM). Every draw is made at
`full` rows, of which the caller's `rows` are kept, so a reference that
follows some rows of a batch sees the noise the whole batch drew.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def cosine_betas(n: int, max_beta: float = 0.999) -> torch.Tensor:
    """Nichol & Dhariwal's cosine schedule, float64 on the host."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return torch.tensor([min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), max_beta)
                         for i in range(n)], dtype=torch.float64)


def ddim_timesteps(n: int, count: int) -> list:
    """`space_timesteps(n, "ddim<count>")`: the smallest integer stride giving `count` steps."""
    for stride in range(1, n):
        if len(range(0, n, stride)) == count:
            return list(range(0, n, stride))
    raise ValueError(f"no integer stride gives {count} of {n} steps")


class Schedule:
    """Coefficient tables in float64, kept as float32 on `device`; `timestep_map`
    gives the original step a respaced position stands for."""

    def __init__(self, betas: torch.Tensor, device, keep: Optional[Sequence[int]] = None):
        betas = betas.double()
        if keep is not None:  # respacing: new betas hit the kept alphas_cumprod
            acp_all = torch.cumprod(1 - betas, 0)
            prev, new = 1.0, []
            for i in keep:
                new.append(1 - acp_all[i].item() / prev)
                prev = acp_all[i].item()
            betas = torch.tensor(new, dtype=torch.float64)
            tmap = list(keep)
        else:
            tmap = list(range(len(betas)))
        acp = torch.cumprod(1 - betas, 0)
        acp_prev = torch.cat([torch.ones(1, dtype=torch.float64), acp[:-1]])
        var = betas * (1 - acp_prev) / (1 - acp)
        log_var = torch.log(torch.cat([var[1:2] if len(var) > 1 else betas[:1], var[1:]]))

        def f32(t):
            return t.float().to(device)
        self.n = len(betas)
        self.alphas_cumprod = f32(acp)
        self.coef1 = f32(betas * torch.sqrt(acp_prev) / (1 - acp))
        self.coef2 = f32((1 - acp_prev) * torch.sqrt(1 - betas) / (1 - acp))
        self.log_var = f32(log_var)
        self.timestep_map = torch.tensor(tmap, dtype=torch.long, device=device)


def _draw(full: Sequence[int], gen: torch.Generator, rows, device) -> torch.Tensor:
    return torch.randn(tuple(full), generator=gen, device=device)[rows]


Model = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddpm(model: Model, sched: Schedule, full: Sequence[int], rows, gen: torch.Generator,
         device) -> torch.Tensor:
    """Ancestral sampling x_T → x_0; `model(x, t)` predicts x_0."""
    x = _draw(full, gen, rows, device)
    for i in range(sched.n - 1, -1, -1):
        t = sched.timestep_map[i].expand(x.shape[0])
        x0 = model(x, t)
        mean = sched.coef1[i] * x0 + sched.coef2[i] * x
        if i > 0:
            x = mean + torch.exp(0.5 * sched.log_var[i]) * _draw(full, gen, rows, device)
        else:
            x = mean
    return x


def dpmpp_2m(model: Model, sched: Schedule, full: Sequence[int], rows, gen: torch.Generator,
             device) -> torch.Tensor:
    """DPM-Solver++(2M) over the schedule's grid: the first step first order, the
    last one to sigma = 0 returning the model's x0 at grid point 0."""
    acp = sched.alphas_cumprod
    alpha, sigma = torch.sqrt(acp), torch.sqrt(1.0 - acp)
    lam = torch.log(alpha) - torch.log(sigma)
    x = _draw(full, gen, rows, device)
    x0_prev, h_prev = None, None
    for i in range(sched.n - 1, 0, -1):
        j = i - 1
        h = lam[j] - lam[i]
        x0 = model(x, sched.timestep_map[i].expand(x.shape[0]))
        if x0_prev is None:
            d = x0
        else:
            r = h_prev / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        x = (sigma[j] / sigma[i]) * x - alpha[j] * (torch.exp(-h) - 1.0) * d
        x0_prev, h_prev = x0, h
    return model(x, sched.timestep_map[0].expand(x.shape[0]))


SAMPLERS = {"ddpm": ddpm, "dpmpp": dpmpp_2m}


def schedule(cfg: dict, respace: int, device) -> Schedule:
    """The configuration's schedule, respaced to `ddim<respace>` when respace > 0."""
    if cfg["noise_schedule"] != "cosine":
        raise ValueError(f"unsupported noise schedule {cfg['noise_schedule']!r}")
    betas = cosine_betas(cfg["diffusion_steps"])
    keep = ddim_timesteps(cfg["diffusion_steps"], respace) if respace else None
    return Schedule(betas, device, keep)


def crossfade_weights(n_seed: int, n: int, device):
    """Linear blend over the first n of the n_seed overlap frames."""
    j = torch.arange(n_seed, dtype=torch.float32, device=device)
    wa = torch.where(j < n, (n - j) / (n + 1), torch.zeros_like(j))
    wb = torch.where(j < n, (j + 1) / (n + 1), torch.ones_like(j))
    return wa, wb
