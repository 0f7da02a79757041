"""Gaussian diffusion math as functions over a `Schedule`.

Port of `diffusestylegesture_tpu/diffusion/gaussian.py` (reference
`main/diffusion/gaussian_diffusion.py:104-1620`, `losses.py`): q_sample,
the posterior, the `predict_*` conversions, p_mean_variance, the masked
SmoothL1 training loss with every mean and variance type, and the
variational-bound terms. `model_fn(x, t)` is the model with its
conditioning closed over; `calc_bpd_loop` hands it original-schedule
timesteps (`schedule.timestep_map[t]`), as every sampler loop does.
"""
from __future__ import annotations

import enum
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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


class LossKind(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
LOG2 = math.log(2.0)


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, broadcast to an x-shaped rank
    (`_extract_into_tensor`, `gaussian_diffusion.py:1607-1619`)."""
    out = table[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_mean_variance(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor):
    """q(x_t | x_0) (ref `:219-234`)."""
    nd = x_start.ndim
    mean = _bcast(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = _bcast(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = _bcast(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


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


def predict_v(sched: Schedule, x_start, t, noise):
    """v = sqrt(a-bar_t) eps - sqrt(1 - a-bar_t) x_0 (Salimans & Ho 2022, eq. 11)."""
    nd = x_start.ndim
    return (_bcast(sched.sqrt_alphas_cumprod, t, nd) * noise
            - _bcast(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)


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


# ---- losses -----------------------------------------------------------------------


def smooth_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise SmoothL1 (Huber, beta 1): `nn.SmoothL1Loss(reduction='none')`,
    which the reference's `masked_l2` uses (`gaussian_diffusion.py:201-207`)."""
    d = a - b
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=tuple(range(1, x.ndim)))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """SmoothL1 averaged over the unmasked entries (ref `:203-216`).
    a, b: (B, J, F, T); mask: (B, 1, 1, T), 1 = keep."""
    mask = mask.float()
    loss = sum_flat(smooth_l1(a, b) * mask)
    return loss / (sum_flat(mask) * (a.shape[1] * a.shape[2]))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians (`main/diffusion/losses.py:12-36`); any of the
    arguments may be a Python float."""
    exp = lambda v: torch.exp(v) if torch.is_tensor(v) else math.exp(v)  # noqa: E731
    return 0.5 * (-1.0 + logvar2 - logvar1 + exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 255 bins on [-1, 1]
    (`main/diffusion/losses.py:50-77`)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(sched: Schedule, model_output: torch.Tensor, x_start: torch.Tensor,
                 x_t: torch.Tensor, t: torch.Tensor, *, mean_type: MeanType,
                 var_type: VarType, clip_denoised: bool = False):
    """The variational-bound term in bits per dim (ref `:1189-1235`):
    (terms (B,), pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_output, x_t, t, mean_type=mean_type,
                          var_type=var_type, clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean, out.log_variance)) / LOG2
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_flat(decoder_nll) / LOG2
    return torch.where(t == 0, decoder_nll, kl), out.pred_xstart


def training_losses(sched: Schedule, model_fn: ModelFn, x_start: torch.Tensor,
                    t: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor, *,
                    mean_type: MeanType = MeanType.START_X,
                    var_type: VarType = VarType.FIXED_SMALL,
                    loss_kind: LossKind = LossKind.MSE,
                    lambda_vel: float = 0.0) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Per-example loss terms and x_t (ref `:1237-1364`; the live config is
    MSE + START_X + FIXED_SMALL: the masked SmoothL1 on the x0 target).
    A learned variance trains through the VB term with the mean prediction
    detached; `lambda_vel` adds the frame-difference velocity term
    (`:1349-1354`, whose `[:, :-1]` drops the last channel, as there)."""
    x_t = q_sample(sched, x_start, t, noise)
    terms: Dict[str, torch.Tensor] = {}
    model_output = model_fn(x_t, t)

    if loss_kind in (LossKind.KL, LossKind.RESCALED_KL):
        out, _ = vb_terms_bpd(sched, model_output, x_start, x_t, t, mean_type=mean_type,
                              var_type=var_type)
        terms["loss"] = out * (sched.num_timesteps if loss_kind == LossKind.RESCALED_KL else 1.0)
        return terms, x_t

    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        C = x_t.shape[1]
        mean_pred, var_values = torch.split(model_output, [C, model_output.shape[1] - C], dim=1)
        frozen = torch.cat([mean_pred.detach(), var_values], dim=1)
        vb, _ = vb_terms_bpd(sched, frozen, x_start, x_t, t, mean_type=mean_type,
                             var_type=var_type)
        if loss_kind == LossKind.RESCALED_MSE:
            vb = vb * (sched.num_timesteps / 1000.0)
        terms["vb"] = vb
        model_output = mean_pred

    if mean_type == MeanType.PREVIOUS_X:
        target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    elif mean_type == MeanType.START_X:
        target = x_start
    elif mean_type == MeanType.VELOCITY:
        target = predict_v(sched, x_start, t, noise)
    else:
        target = noise

    terms["rot_mse"] = masked_l2(target, model_output, mask)
    loss = terms["rot_mse"]
    if "vb" in terms:
        loss = loss + terms["vb"]
    if lambda_vel > 0.0:
        target_vel = target[..., 1:] - target[..., :-1]
        model_vel = model_output[..., 1:] - model_output[..., :-1]
        terms["vel_mse"] = masked_l2(target_vel[:, :-1], model_vel[:, :-1], mask[..., 1:])
        loss = loss + lambda_vel * terms["vel_mse"]
    terms["loss"] = loss
    return terms, x_t


def prior_bpd(sched: Schedule, x_start: torch.Tensor) -> torch.Tensor:
    """The prior KL term in bits per dim (ref `_prior_bpd:1531-1547`)."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(sched, x_start, t)
    return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / LOG2


@torch.no_grad()
def calc_bpd_loop(sched: Schedule, model_fn: ModelFn, x_start: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  mean_type: MeanType = MeanType.START_X,
                  var_type: VarType = VarType.FIXED_SMALL, clip_denoised: bool = False,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The full variational bound in bits per dim over t = T-1 … 0
    (ref `calc_bpd_loop:1549-1604`): {total_bpd, prior_bpd, vb (N, T),
    xstart_mse (N, T), mse (N, T)}, the T axis in that order. Each step's
    noise is drawn from `generator`, or is `noise[i]` for the i-th step."""
    B, T = x_start.shape[0], sched.num_timesteps
    vb, xstart_mse, mse = [], [], []
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=x_start.device)
        eps = (noise[i] if noise is not None else
               torch.randn(x_start.shape, generator=generator, device=x_start.device))
        x_t = q_sample(sched, x_start, t, eps)
        out = model_fn(x_t, sched.timestep_map[t])
        terms, pred_xstart = vb_terms_bpd(sched, out, x_start, x_t, t, mean_type=mean_type,
                                          var_type=var_type, clip_denoised=clip_denoised)
        vb.append(terms)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        mse.append(mean_flat((predict_eps_from_xstart(sched, x_t, t, pred_xstart) - eps) ** 2))
    vb_t = torch.stack(vb, dim=1)
    pb = prior_bpd(sched, x_start)
    return {"total_bpd": vb_t.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb_t,
            "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}
