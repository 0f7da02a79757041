"""Progressive distillation for few-step sampling (Salimans & Ho 2022).

Port of `diffusestylegesture_tpu/train/distill.py`: a student is trained so
that ONE of its DDIM steps reproduces TWO consecutive DDIM steps of the
teacher, halving the chain per stage (1000 → 500 → 250 …), and each stage's
student becomes the next teacher. Both networks predict x0 (START_X). The
target is the closed form of the JAX module: the teacher runs two DDIM
(eta = 0) steps x_t → x_{t-2}, and x0* is the x0 whose single student step
from x_t lands exactly on x_{t-2}:

    f = sqrt((1 − ab2) / (1 − ab_t)),   x0* = (x_{t-2} − f x_t) / (sqrt(ab2) − f sqrt(ab_t))

The teacher's two calls are inference: in the port the teacher is an `MDM`
with `impl="kernel"` under `no_grad`, so they run through the CUDA kernels
A (local attention) and B (encoder layer) on a card. The student trains
through the plain ops with autograd (`impl="plain"`; the kernels have no
backward), with `optax.adam(lr)`, which is the port's flat `AdamW` with no
weight decay and no anneal (`TrainState(student, TrainConfig(lr=lr))`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..diffusion import gaussian as G
from ..diffusion.schedule import Schedule, spaced_schedule
from .state import TrainState


def student_schedule(teacher: Schedule, base_betas: Optional[np.ndarray] = None) -> Schedule:
    """Half-step schedule, on the teacher's device: keeps every second of the
    teacher's timesteps (`timestep_map[1::2]`).

    `base_betas` are the ORIGINAL (unspaced) betas; when None the teacher must
    be unspaced, and its betas are reconstructed from `alphas_cumprod`."""
    if base_betas is None:
        ac = teacher.alphas_cumprod.cpu().numpy().astype(np.float64)
        prev = np.concatenate([[1.0], ac[:-1]])
        base_betas = 1.0 - ac / prev
        base_map = teacher.timestep_map.cpu().numpy()
        if not (base_map == np.arange(len(base_map))).all():
            raise ValueError("pass base_betas for an already-respaced teacher")
    use = set(teacher.timestep_map.cpu().numpy()[1::2].tolist())
    return spaced_schedule(base_betas, use, device=teacher.device)


def ddim_step(sched: Schedule, x: torch.Tensor, t: torch.Tensor,
              x0_pred: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM (eta = 0) step x_t → x_{t-1} given the predicted x0."""
    eps = G.predict_eps_from_xstart(sched, x, t, x0_pred)
    ab_prev = G._bcast(sched.alphas_cumprod_prev, t, x.ndim)
    return x0_pred * torch.sqrt(ab_prev) + torch.sqrt(1.0 - ab_prev) * eps


def two_step_target(sched_t: Schedule, teacher_fn: Callable, x: torch.Tensor,
                    t: torch.Tensor):
    """(x0*, x_{t-2}): the teacher runs x_t → x_{t-1} → x_{t-2}, and x0* is what
    the student must predict at (x_t, t) so that one step lands on x_{t-2}.

    `t` indexes the (possibly respaced) schedule; the network sees the
    original timesteps through `timestep_map`, so every stage keeps one
    timestep vocabulary."""
    nd = x.ndim
    x0_a = teacher_fn(x, sched_t.timestep_map[t])
    x_mid = ddim_step(sched_t, x, t, x0_a)
    t_mid = torch.clamp(t - 1, min=0)
    x0_b = teacher_fn(x_mid, sched_t.timestep_map[t_mid])
    x_tgt = ddim_step(sched_t, x_mid, t_mid, x0_b)

    ab_t = G._bcast(sched_t.alphas_cumprod, t, nd)
    ab_2 = G._bcast(sched_t.alphas_cumprod_prev, t_mid, nd)
    frac = torch.sqrt((1.0 - ab_2) / (1.0 - ab_t))
    denom = torch.sqrt(ab_2) - frac * torch.sqrt(ab_t)
    # at the final step ab_2 → 1: denom stays > 0 for any usable schedule
    return (x_tgt - frac * x) / denom, x_tgt


def make_distill_step(teacher: torch.nn.Module, sched_teacher: Schedule) -> Callable:
    """step(state, x0, cond, generator, *, t=None, noise=None) → {'loss'}.

    `state` is the student's `TrainState` (its model, `impl="plain"`, and the
    flat Adam). From `generator`, in this order (as the JAX step draws t and
    then the noise): t = 2i + 1 with i uniform in [0, nt//2), so t is one of
    the teacher's odd indices, the student grid; then the noise. `t=` and
    `noise=` inject them instead. x_t = q_sample(x0, t, noise); both networks
    see `timestep_map[t]` and the same `cond`, with no dropout and no
    condition drop (the JAX `model.apply` without `train`). The loss is
    mean(max(1, ab/(1−ab)) · (pred − x0*)²) with x0* from the frozen teacher
    under `no_grad`. Every state update is written into the state's buffers
    and nothing is read on the host, so the step can be captured as one CUDA
    graph (`utils/graphs.py::CapturedStep`); the caller counts the steps.
    """
    nt = sched_teacher.num_timesteps
    teacher.requires_grad_(False)

    def step(state: TrainState, x0: torch.Tensor, cond: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], *, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        B, dev = x0.shape[0], x0.device
        if t is None:
            t = 2 * torch.randint(0, nt // 2, (B,), generator=generator, device=dev) + 1
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev)
        x_t = G.q_sample(sched_teacher, x0, t, noise)
        state.params.grad.zero_()
        pred = state.model(x_t, sched_teacher.timestep_map[t], cond)
        with torch.no_grad():
            target, _ = two_step_target(sched_teacher, lambda x, tt: teacher(x, tt, cond),
                                        x_t, t)
        ab = G._bcast(sched_teacher.alphas_cumprod, t, x0.ndim)
        w = torch.clamp(ab / (1.0 - ab), min=1.0)  # truncated-SNR weight
        loss = torch.mean(w * (pred - target) ** 2)
        loss.backward()
        state.optimizer.step()
        return {"loss": loss.detach()}

    return step
