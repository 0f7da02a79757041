"""Reverse-process samplers as step functions over tensors that stay in place.

Port of `diffusestylegesture_tpu/diffusion/sampling.py` (reference
`gaussian_diffusion.py:506-1087`, `cfg_sampler.py`): ancestral DDPM, DDIM,
PLMS and DPM-Solver++(2M), each calling ``model_fn(x, t)`` once per step
(PLMS twice on its first step) with ORIGINAL-schedule timesteps
(``sched.timestep_map[t]``), with the ``noise=`` (x_T), ``skip_timesteps`` /
``init_image`` (warm start) and ``inpaint=`` hooks. Randomness comes from an
explicit `torch.Generator`.

The JAX package writes each loop as one `lax.scan`. Here each loop is a
`SampleProgram`: a few step functions that read the step index from a 0-d
device tensor (`idx`, which each step decrements itself) and overwrite the
loop's state (`img`, PLMS's eps history, DPM++'s previous x0 and step)
in place. No Python number that changes from step to step enters a step, so
one function serves every step of its kind, and the same functions can run
eagerly or be captured once into CUDA graphs and replayed
(`utils/graphs.py`): both give the same numbers. `phases` lists the step
functions in order with the number of steps each takes; the loop functions
below run them eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from ..parallel import draws
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


@dataclasses.dataclass(frozen=True)
class Phase:
    """`count` consecutive steps taken by `fn`; `name` tells the kind apart."""
    name: str
    fn: Callable[[], None]
    count: int


def _phases(kinds: List[Tuple], make: Callable[..., Callable[[], None]]) -> List[Phase]:
    """Per-step kinds, in step order → phases of equal consecutive kinds."""
    out: List[Phase] = []
    for kind in kinds:
        if out and out[-1].name == repr(kind):
            out[-1] = dataclasses.replace(out[-1], count=out[-1].count + 1)
        else:
            out.append(Phase(repr(kind), make(*kind), 1))
    return out


def model_stats(sched: Schedule, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                cfg: SamplerConfig,
                inpaint: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> G.PMeanVariance:
    """The model's output at (x, t) and the posterior statistics it gives; the
    network sees the original timesteps (`timestep_map[t]`). `inpaint=(mask,
    motion)` puts `motion` in place of the x0 prediction where `mask` is set."""
    model_output = model_fn(x, sched.timestep_map[t])
    if inpaint is not None:
        mask, motion = inpaint
        model_output = torch.where(mask, motion, model_output)
    return G.p_mean_variance(sched, model_output, x, t, mean_type=cfg.mean_type,
                             var_type=cfg.var_type, clip_denoised=cfg.clip_denoised)


class SampleProgram:
    """One reverse-diffusion loop over the schedule's grid t0 → 0.

    `init(noise, init_image)` sets x_T (drawn from `generator` unless given)
    and the step index; running every phase's `fn` `count` times in order
    then leaves the sample in `img`. `inpaint=(mask, motion)` replaces the
    model's x0 prediction by `motion` where `mask` is True at every step
    (START_X only, ref `gaussian_diffusion.py:317-324`); the loop reads the
    two tensors where they lie, so a caller may refill them between runs.
    """

    def __init__(self, sched: Schedule, model_fn: ModelFn, shape,
                 generator: draws.Draws = None, *,
                 cfg: SamplerConfig = SamplerConfig(), skip_timesteps: int = 0,
                 inpaint: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        if inpaint is not None and cfg.mean_type != G.MeanType.START_X:
            raise ValueError("inpainting requires mean_type=START_X (ref "
                             "gaussian_diffusion.py:318): an x0-space motion would be "
                             f"read as a {cfg.mean_type.value} prediction")
        self.sched, self.model_fn, self.cfg = sched, model_fn, cfg
        self.shape = tuple(shape)
        self.generator = generator
        self.inpaint = inpaint
        self.skip_timesteps = skip_timesteps
        self.t0 = sched.num_timesteps - skip_timesteps - 1
        dev = sched.device
        self.img = torch.zeros(self.shape, device=dev)
        self.idx = torch.zeros((), dtype=torch.long, device=dev)
        self.phases = self._build()

    def _build(self) -> List[Phase]:
        raise NotImplementedError

    # ---- pieces every step uses ----

    def _t(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        return (self.idx if idx is None else idx).expand(self.shape[0])

    def _randn(self) -> torch.Tensor:
        """x_T and the steps' noise. A `GlobalDraws` generator (a card of a
        serving mesh holding some rows of the batch) draws for the whole batch
        and keeps its rows, as the unsharded run draws them."""
        return draws.randn(self.shape, self.generator, self.sched.device)

    def _stats(self, x: torch.Tensor, t: torch.Tensor) -> G.PMeanVariance:
        return model_stats(self.sched, self.model_fn, x, t, self.cfg, self.inpaint)

    def init(self, noise: Optional[torch.Tensor] = None,
             init_image: Optional[torch.Tensor] = None) -> None:
        """x_T (+ warm start by q-sampling the init image to t0, ref `:700-713`)."""
        img = self._randn() if noise is None else noise
        if self.skip_timesteps and init_image is None:
            init_image = torch.zeros(self.shape, device=self.sched.device)
        if init_image is not None:
            img = G.q_sample(self.sched, init_image,
                             torch.full((self.shape[0],), self.t0, dtype=torch.long,
                                        device=self.sched.device), img)
        self.img.copy_(img)
        self.idx.fill_(self.t0)

    def run(self) -> torch.Tensor:
        """Every step, eagerly; returns `img`."""
        for phase in self.phases:
            for _ in range(phase.count):
                phase.fn()
        return self.img


class DDPMProgram(SampleProgram):
    """Ancestral DDPM (ref `p_sample_loop:608`); the noise is masked at t = 0."""

    def _build(self):
        return _phases([(True,)] * self.t0 + [(False,)], self._step)

    def _step(self, noise: bool):
        def fn():
            out = self._stats(self.img, self._t())
            if noise:
                z = self._randn()
                if self.cfg.const_noise:
                    z = z[:1].expand(self.shape)
                self.img.copy_(out.mean + torch.exp(0.5 * out.log_variance) * z)
            else:
                self.img.copy_(out.mean)
            self.idx.sub_(1)
        return fn


class DDIMProgram(SampleProgram):
    """DDIM with eta (ref `ddim_sample:742`); no noise at t = 0."""

    def _build(self):
        return _phases([(bool(self.cfg.eta),)] * self.t0 + [(False,)], self._step)

    def _step(self, noise: bool):
        def fn():
            sched, nd, t = self.sched, len(self.shape), self._t()
            out = self._stats(self.img, t)
            eps = G.predict_eps_from_xstart(sched, self.img, t, out.pred_xstart)
            alpha_bar = G._bcast(sched.alphas_cumprod, t, nd)
            alpha_bar_prev = G._bcast(sched.alphas_cumprod_prev, t, nd)
            sigma = (self.cfg.eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                     * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
            img = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                   + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
            if noise:
                img = img + sigma * self._randn()
            self.img.copy_(img)
            self.idx.sub_(1)
        return fn


_AB = (
    (1.0,),
    (3.0 / 2.0, -1.0 / 2.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


class PLMSProgram(SampleProgram):
    """PLMS / Adams–Bashforth (ref `plms_sample:1005-1087`): the order ramps
    1 → `cfg.order` as the eps history fills; for order > 1 the first step
    is the reference's pseudo improved-Euler double evaluation. Step s of the
    loop (i = t0 − s) reads min(s, order − 1) history entries; each ramp
    length is a step function of its own."""

    def _build(self):
        order = int(self.cfg.order)
        if not 1 <= order <= 4:
            raise ValueError("order must be in [1, 4]")
        self.hist = [torch.zeros(self.shape, device=self.sched.device)
                     for _ in range(order - 1)]  # previous eps, newest first
        kinds = []
        for s in range(self.t0 + 1):
            if order == 1:
                kind = "plain", 0
            elif s == 0:
                kind = "euler", 0
            else:
                kind = "adams", min(s, order - 1)
            kinds.append(kind + (s == self.t0,))
        return _phases(kinds, self._step)

    def _eps(self, x, t):
        out = self._stats(x, t)
        return G.predict_eps_from_xstart(self.sched, x, t, out.pred_xstart), out

    def _step(self, kind: str, n_hist: int, last: bool):
        def fn():
            sched, nd, t = self.sched, len(self.shape), self._t()
            alpha_bar_prev = G._bcast(sched.alphas_cumprod_prev, t, nd)
            eps, out = self._eps(self.img, t)
            if kind == "plain":
                eps_prime = eps
            elif kind == "euler":
                mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                             + torch.sqrt(1 - alpha_bar_prev) * eps)
                eps2, _ = self._eps(mean_pred, self._t((self.idx - 1).clamp(min=0)))
                eps_prime = (eps + eps2) / 2.0
            else:
                h = [eps] + self.hist[:n_hist]
                coef = _AB[len(h) - 1]
                eps_prime = coef[0] * h[0]
                for c, e in zip(coef[1:], h[1:]):
                    eps_prime = eps_prime + c * e
            pred_prime = G.predict_xstart_from_eps(sched, self.img, t, eps_prime)
            mean_pred = (pred_prime * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev) * eps_prime)
            for j in range(len(self.hist) - 1, 0, -1):
                self.hist[j].copy_(self.hist[j - 1])
            if self.hist:
                self.hist[0].copy_(eps)
            self.img.copy_(out.pred_xstart if last else mean_pred)
            self.idx.sub_(1)
        return fn


class DPMPPProgram(SampleProgram):
    """DPM-Solver++(2M) (Lu et al. 2022), data-prediction multistep form over
    the schedule's own grid t0 → 0; the first step is first order, and the
    last step, to σ = 0, returns the model's x0 prediction at grid point 0."""

    def _build(self):
        acp = self.sched.alphas_cumprod
        self.alpha = torch.sqrt(acp)
        self.sigma = torch.sqrt(1.0 - acp)
        self.lam = torch.log(self.alpha) - torch.log(self.sigma)
        self.x0_prev = torch.zeros(self.shape, device=self.sched.device)
        self.h_prev = torch.zeros(1, device=self.sched.device)
        kinds = [(True,)] + [(False,)] * (self.t0 - 1) if self.t0 > 0 else []
        return _phases(kinds, self._step) + [Phase("final", self._final, 1)]

    def _x0(self, x, t):
        return self._stats(x, t).pred_xstart

    def _step(self, first: bool):
        def fn():
            # (1,)-shaped indices: PyTorch reads a 0-d index tensor on the host
            i = self.idx.view(1)
            j = i - 1
            h = self.lam[j] - self.lam[i]
            x0 = self._x0(self.img, self._t())
            if first:
                d = x0
            else:
                r = self.h_prev / h
                d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * self.x0_prev
            self.img.copy_((self.sigma[j] / self.sigma[i]) * self.img
                           - self.alpha[j] * (torch.exp(-h) - 1.0) * d)
            self.x0_prev.copy_(x0)
            self.h_prev.copy_(h)
            self.idx.sub_(1)
        return fn

    def _final(self):
        self.img.copy_(self._x0(self.img, self._t()))  # idx is 0 here


PROGRAMS = {"ddpm": DDPMProgram, "ddim": DDIMProgram, "plms": PLMSProgram,
            "dpmpp": DPMPPProgram}


def _loop(program_cls, name: str):
    def loop(sched: Schedule, model_fn: ModelFn, shape,
             generator: Optional[torch.Generator] = None, *,
             cfg: SamplerConfig = SamplerConfig(), noise: Optional[torch.Tensor] = None,
             skip_timesteps: int = 0, init_image: Optional[torch.Tensor] = None,
             inpaint: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        prog = program_cls(sched, model_fn, shape, generator, cfg=cfg,
                           skip_timesteps=skip_timesteps, inpaint=inpaint)
        prog.init(noise, init_image)
        return prog.run()

    loop.__name__ = loop.__qualname__ = name
    loop.__doc__ = f"The loop of `{program_cls.__name__}`, run eagerly; returns x_0."
    return loop


p_sample_loop = _loop(DDPMProgram, "p_sample_loop")
ddim_sample_loop = _loop(DDIMProgram, "ddim_sample_loop")
plms_sample_loop = _loop(PLMSProgram, "plms_sample_loop")
dpmpp2m_sample_loop = _loop(DPMPPProgram, "dpmpp2m_sample_loop")


def ddim_reverse_sample(sched: Schedule, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor, *,
                        cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """One DDIM reverse-ODE step x_t → x_{t+1} (ref `gaussian_diffusion.py:851-888`;
    the deterministic encoding direction)."""
    out = model_stats(sched, model_fn, x, t, cfg)
    eps = G.predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    alpha_bar_next = G._bcast(sched.alphas_cumprod_next, t, x.ndim)
    return out.pred_xstart * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps


def ddim_reverse_sample_loop(sched: Schedule, model_fn: ModelFn, x0: torch.Tensor, *,
                             cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Encode x_0 → x_T along the deterministic DDIM ODE (the inversion used for
    editing and latent round trips): one step for each t = 0 … T−1."""
    img = x0
    for i in range(sched.num_timesteps):
        t = torch.full((x0.shape[0],), i, dtype=torch.long, device=x0.device)
        img = ddim_reverse_sample(sched, model_fn, img, t, cfg=cfg)
    return img


def cfg_combine(out_cond: torch.Tensor, out_uncond: torch.Tensor, scale) -> torch.Tensor:
    """Classifier-free guidance mix (`main/model/cfg_sampler.py:25-31`)."""
    return out_uncond + scale * (out_cond - out_uncond)


def make_cfg_model_fn(model_apply, scale, batch_size: int, *, params=None,
                      cond=None) -> Callable:
    """CFG model_fn: the cond and uncond passes run as one doubled batch.

    Bare form ``model_apply(x, t, uncond_mask)``; engine form (``params``
    and ``cond`` given) ``model_apply(params, x, t, cond, uncond=mask)``
    with every conditioning tensor doubled along the batch axis at each call,
    so a caller may refill the tensors of `cond` between calls.
    """
    B = batch_size

    def fn(x, t):
        x2 = torch.cat([x, x], 0)
        t2 = torch.cat([t, t], 0)
        uncond = torch.cat([torch.zeros(B, dtype=torch.bool, device=x.device),
                            torch.ones(B, dtype=torch.bool, device=x.device)])
        if cond is None:
            out = model_apply(x2, t2, uncond)
        else:
            cond2 = {k: torch.cat([v, v], 0) for k, v in cond.items()}
            out = model_apply(params, x2, t2, cond2, uncond=uncond)
        return cfg_combine(out[:B], out[B:], scale)

    return fn
