"""Motion re-styling by DDIM inversion.

Port of `diffusestylegesture_tpu/sample/restyle.py`: an existing pose window
(ground truth or generated) is inverted to the diffusion latent along the
deterministic DDIM ODE under its own conditioning
(`diffusion.ddim_reverse_sample`), then decoded under another style. Timing
and audio sync ride on the latent and the audio conditioning, the style on
the new condition (the SDEdit / DDIM-inversion recipe on the gesture
denoiser).

`strength` in (0, 1] selects how far up the chain to invert: 1.0 runs the
whole ODE to x_T (the most freedom to re-style); smaller values keep more of
the source motion. The JAX module's two `lax.scan`s are two loops over the
same step functions.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..diffusion import SamplerConfig, Schedule
from ..diffusion.sampling import ddim_reverse_sample, model_stats
from ..train.distill import ddim_step


@torch.inference_mode()
def restyle_window(sched: Schedule, model_apply: Callable, motion: torch.Tensor,
                   cond_src: Dict, cond_tgt: Dict, *, strength: float = 1.0,
                   cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Invert `motion` (B, C, 1, T, normalized) under `cond_src`, decode it under
    `cond_tgt`; `model_apply(x, t, cond)` is the x0 prediction.

    Level bookkeeping: the inversion over i = 0 … t_hi−1 walks ab[0] → ab[t_hi]
    (the clean input stands in for level ab[0], the usual head approximation,
    whose error (1−ab[0]) vanishes with the step count); the decode over
    j = t_hi … 0 walks back ab[t_hi] → ab[0] → clean (ab_prev[0] = 1), each step
    evaluated at the level its state is at: a decode one index lower leaves an
    O(1) drift.
    """
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must lie in (0, 1], not {strength}")
    t_hi = min(max(1, int(round(sched.num_timesteps * strength))), sched.num_timesteps - 1)
    B, dev = motion.shape[0], motion.device

    def steps(indices):
        for i in indices:
            yield torch.full((B,), i, dtype=torch.long, device=dev)

    x = motion
    for t in steps(range(t_hi)):
        x = ddim_reverse_sample(sched, lambda xx, tt: model_apply(xx, tt, cond_src), x, t, cfg=cfg)
    for t in steps(range(t_hi, -1, -1)):
        out = model_stats(sched, lambda xx, tt: model_apply(xx, tt, cond_tgt), x, t, cfg)
        x = ddim_step(sched, x, t, out.pred_xstart)
    return x
