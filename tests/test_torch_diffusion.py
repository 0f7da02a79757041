"""Diffusion core of the PyTorch port vs the JAX package.

Schedules and respacing equal the JAX tables (both build them in float64
numpy and store float32); one p_mean_variance step agrees at 1e-6; the
deterministic samplers (DDIM eta 0, DPM-Solver++(2M), PLMS) driven by the
same x_T and the same toy model agree along the whole trajectory at 1e-5.
Ancestral DDPM draws its per-step noise inside `lax.scan` in JAX, so it is
held through the one-step test plus shape and determinism checks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.diffusion import gaussian as JG
from diffusestylegesture_tpu.diffusion import sampling as JS
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.diffusion import gaussian as TG

from torch_port_utils import np32

SHAPE = (2, 6, 1, 9)
FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
          "fixed_large_variance", "fixed_large_log_variance", "log_betas", "timestep_map")


def _schedules(kind):
    if kind == "cosine1000":
        betas = JD.named_beta_schedule("cosine", 1000)
        return JD.Schedule.create(betas), TD.Schedule.create(betas, device="cpu")
    if kind == "linear100":
        betas = JD.named_beta_schedule("linear", 100)
        return JD.Schedule.create(betas), TD.Schedule.create(betas, device="cpu")
    steps = {"ddim10": "ddim10", "ddim5": "ddim5", "sections": "3,4"}[kind]
    betas = JD.named_beta_schedule("cosine", 1000)
    use = JD.space_timesteps(1000, steps)
    return JD.spaced_schedule(betas, use), TD.spaced_schedule(betas, use, device="cpu")


@pytest.mark.parametrize("kind", ["cosine1000", "linear100", "ddim10", "sections"])
def test_schedule_tables_equal_jax(kind):
    js, ts = _schedules(kind)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ts, f)), np.asarray(getattr(js, f)),
                                      err_msg=f)


@pytest.mark.parametrize("spec", ["ddim5", "ddim100", "10", "3,4,5", "1,1"])
def test_space_timesteps_equal_jax(spec):
    assert TD.space_timesteps(1000, spec) == JD.space_timesteps(1000, spec)


@pytest.mark.parametrize("mean_type", ["START_X", "EPSILON"])
def test_p_mean_variance_one_step(mean_type):
    js, ts = _schedules("cosine1000")
    rng = np.random.default_rng(0)
    x, out = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([999, 17], np.int64)
    j = JG.p_mean_variance(js, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t),
                           mean_type=getattr(JG.MeanType, mean_type))
    p = TG.p_mean_variance(ts, torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t),
                           mean_type=getattr(TG.MeanType, mean_type))
    for a, b in zip(p, j):
        np.testing.assert_allclose(np32(a), np.asarray(b), atol=1e-6, rtol=1e-6)


def _toy_models():
    """The same deterministic x0 predictor in both frameworks."""
    w = np.random.default_rng(1).standard_normal(SHAPE[1:]).astype(np.float32) * 0.3

    def jax_fn(x, t):
        return jnp.tanh(0.7 * x + jnp.asarray(w)) * (1.0 + t[:, None, None, None] / 1000.0)

    def torch_fn(x, t):
        return torch.tanh(0.7 * x + torch.from_numpy(w)) * (1.0 + t[:, None, None, None] / 1000.0)

    return jax_fn, torch_fn


@pytest.mark.parametrize("sampler,kind,cfg_kw", [
    ("ddim", "ddim10", {}),
    ("dpmpp", "ddim5", {}),
    ("dpmpp", "ddim10", {}),
    ("plms", "ddim10", {"order": 2}),
    ("plms", "ddim10", {"order": 4}),
])
def test_deterministic_trajectories_equal_jax(sampler, kind, cfg_kw):
    js, ts = _schedules(kind)
    jax_fn, torch_fn = _toy_models()
    noise = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    jloop = {"ddim": JS.ddim_sample_loop, "dpmpp": JS.dpmpp2m_sample_loop,
             "plms": JS.plms_sample_loop}[sampler]
    tloop = {"ddim": TD.ddim_sample_loop, "dpmpp": TD.dpmpp2m_sample_loop,
             "plms": TD.plms_sample_loop}[sampler]
    ref = jloop(js, jax_fn, SHAPE, jax.random.PRNGKey(0), cfg=JS.SamplerConfig(**cfg_kw),
                noise=jnp.asarray(noise))
    out = tloop(ts, torch_fn, SHAPE, None, cfg=TD.SamplerConfig(**cfg_kw),
                noise=torch.from_numpy(noise))
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_skip_timesteps_warm_start_equals_jax():
    js, ts = _schedules("ddim10")
    jax_fn, torch_fn = _toy_models()
    noise = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    ref = JS.ddim_sample_loop(js, jax_fn, SHAPE, jax.random.PRNGKey(0),
                              noise=jnp.asarray(noise), skip_timesteps=3)
    out = TD.ddim_sample_loop(ts, torch_fn, SHAPE, None, noise=torch.from_numpy(noise),
                              skip_timesteps=3)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_ddpm_shape_and_determinism():
    _, ts = _schedules("ddim10")
    _, torch_fn = _toy_models()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return TD.p_sample_loop(ts, torch_fn, SHAPE, g)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == SHAPE and torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_cfg_combine_and_model_fn():
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        np32(TD.cfg_combine(torch.from_numpy(a), torch.from_numpy(b), 2.5)),
        np.asarray(JS.cfg_combine(jnp.asarray(a), jnp.asarray(b), 2.5)), atol=1e-6)

    def bare(x, t, uncond):  # cond rows see +1, uncond rows -1
        return x + torch.where(uncond, -1.0, 1.0)[:, None, None, None]

    x = torch.from_numpy(a)
    fn = TD.make_cfg_model_fn(bare, 3.0, SHAPE[0])
    np.testing.assert_allclose(np32(fn(x, torch.zeros(SHAPE[0], dtype=torch.long))),
                               np32(x - 1.0 + 3.0 * 2.0), atol=1e-6)
