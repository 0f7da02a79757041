"""Noise schedules and precomputed diffusion coefficient tables.

Port of `diffusestylegesture_tpu/diffusion/schedule.py` (reference
`main/diffusion/gaussian_diffusion.py:21-65,161-199`, `respace.py`): the
linear and cosine schedules and every derived table are computed in
float64 numpy, then stored as float32 tensors on the schedule's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device


def linear_betas(num_timesteps: int, scale_betas: float = 1.0) -> np.ndarray:
    """Ho et al. linear schedule scaled to any step count (ref `:30-38`)."""
    scale = scale_betas * 1000 / num_timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64)


def cosine_betas(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (ref `:39-65`), float64."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def named_beta_schedule(name: str, num_timesteps: int, scale_betas: float = 1.0) -> np.ndarray:
    if name == "linear":
        return linear_betas(num_timesteps, scale_betas)
    if name == "cosine":
        return cosine_betas(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {name}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """All per-timestep diffusion coefficients, as float32 tensors."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    log_betas: torch.Tensor
    # respaced schedules: position in this schedule → original timestep
    # fed to the model (`respace.py:64-129`); identity otherwise
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    @classmethod
    def create(cls, betas: np.ndarray, timestep_map: Optional[np.ndarray] = None,
               device: Union[str, torch.device] = "cuda") -> "Schedule":
        dev = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        T = betas.shape[0]

        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        # single-step schedules have no posterior_variance[1]: fall back to beta_0
        pv1 = posterior_variance[1] if len(posterior_variance) > 1 else betas[0]
        posterior_log_variance_clipped = np.log(np.append(pv1, posterior_variance[1:]))
        fixed_large_variance = np.append(pv1, betas[1:])

        if timestep_map is None:
            timestep_map = np.arange(T)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            alphas_cumprod_next=f32(alphas_cumprod_next),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
            fixed_large_variance=f32(fixed_large_variance),
            fixed_large_log_variance=f32(np.log(fixed_large_variance)),
            log_betas=f32(np.log(betas)),
            timestep_map=torch.as_tensor(np.asarray(timestep_map, np.int64), device=dev),
        )


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Subset of original timesteps for respaced sampling (`respace.py:8-61`),
    including the ``ddimN`` fixed-stride string form."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {num_timesteps} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


def spaced_schedule(betas: np.ndarray, use_timesteps,
                    device: Union[str, torch.device] = "cuda") -> Schedule:
    """Respaced `Schedule` (`respace.py:64-116`): new betas make the
    respaced chain's alphas_cumprod hit the kept original values."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    use_timesteps = set(use_timesteps)
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, acp in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - acp / last_alpha_cumprod)
            last_alpha_cumprod = acp
            timestep_map.append(i)
    return Schedule.create(np.array(new_betas), np.array(timestep_map), device=device)
