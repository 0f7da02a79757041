"""The port's sampling loops as step programs vs the JAX loops.

Each loop is a `SampleProgram`: step functions that read the step index from
a device tensor and overwrite their state in place (what a CUDA graph
replays). Driven by the same x_T, the same toy model and, for the ancestral
samplers, the same per-step noise (the JAX loops' own draws, replayed into
the port's program), all four loops agree with the JAX loops along the
whole trajectory at 1e-5, the bar of `test_torch_diffusion.py`. The
`inpaint` hook agrees too (DDIM and DPM++, half the motion masked), and
raises unless the mean type is START_X, as the JAX assert does.
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
from diffusestylegesture_torch.diffusion import sampling as TS

from torch_port_utils import np32

SHAPE = (2, 6, 1, 9)
JLOOPS = {"ddpm": JS.p_sample_loop, "ddim": JS.ddim_sample_loop, "plms": JS.plms_sample_loop,
          "dpmpp": JS.dpmpp2m_sample_loop}
TLOOPS = {"ddpm": TD.p_sample_loop, "ddim": TD.ddim_sample_loop, "plms": TD.plms_sample_loop,
          "dpmpp": TD.dpmpp2m_sample_loop}


def _schedules(steps):
    betas = JD.named_beta_schedule("cosine", 1000)
    use = JD.space_timesteps(1000, f"ddim{steps}")
    return JD.spaced_schedule(betas, use), TD.spaced_schedule(betas, use, device="cpu")


def _toy_models():
    w = np.random.default_rng(1).standard_normal(SHAPE[1:]).astype(np.float32) * 0.3

    def jax_fn(x, t):
        return jnp.tanh(0.7 * x + jnp.asarray(w)) * (1.0 + t[:, None, None, None] / 1000.0)

    def torch_fn(x, t):
        return torch.tanh(0.7 * x + torch.from_numpy(w)) * (1.0 + t[:, None, None, None] / 1000.0)

    return jax_fn, torch_fn


def _jax_step_noise(key, steps, shape=SHAPE):
    """The per-step draws of the JAX DDPM / DDIM scans for `key`, in step order."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.array(jax.random.normal(nkey, shape, dtype=jnp.float32)))
    return out


def _run_program(name, sched, model_fn, noise, cfg, step_noise=None, **kw):
    """The port's program, each step's draw replaced by the given arrays."""
    prog = TS.PROGRAMS[name](sched, model_fn, SHAPE, None, cfg=cfg, **kw)
    if step_noise is not None:
        draws = iter(step_noise)
        prog._randn = lambda: torch.from_numpy(next(draws))
    prog.init(torch.from_numpy(noise))
    return prog.run()


@pytest.mark.parametrize("name,steps,skip,cfg_kw", [
    ("ddpm", 10, 0, {}),
    ("ddpm", 5, 0, {"const_noise": True}),
    ("ddpm", 5, 2, {}),
    ("ddim", 10, 0, {}),
    ("ddim", 10, 0, {"eta": 0.5}),
    ("plms", 10, 0, {"order": 1}),
    ("plms", 10, 0, {"order": 3}),
    ("plms", 2, 0, {"order": 4}),
    ("dpmpp", 5, 0, {}),
    ("dpmpp", 2, 1, {}),
])
def test_program_trajectories_equal_jax(name, steps, skip, cfg_kw):
    js, ts = _schedules(steps)
    jax_fn, torch_fn = _toy_models()
    noise = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = JLOOPS[name](js, jax_fn, SHAPE, key, cfg=JS.SamplerConfig(**cfg_kw),
                       noise=jnp.asarray(noise), skip_timesteps=skip)
    out = _run_program(name, ts, torch_fn, noise, TS.SamplerConfig(**cfg_kw),
                       step_noise=_jax_step_noise(key, steps), skip_timesteps=skip)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["ddim", "dpmpp"])
def test_inpaint_equals_jax(name):
    js, ts = _schedules(10)
    jax_fn, torch_fn = _toy_models()
    rng = np.random.default_rng(4)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    motion = rng.standard_normal(SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, bool)
    mask[..., : SHAPE[-1] // 2] = True  # the first half of the frames is given
    ref = JLOOPS[name](js, jax_fn, SHAPE, jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                       inpaint=(jnp.asarray(mask), jnp.asarray(motion)))
    out = TLOOPS[name](ts, torch_fn, SHAPE, None, noise=torch.from_numpy(noise),
                       inpaint=(torch.from_numpy(mask), torch.from_numpy(motion)))
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # the model's x0 prediction is the motion where the mask holds: the last
    # step of each loop returns x0 there
    np.testing.assert_allclose(np32(out)[mask], motion[mask], atol=1e-5)


def test_inpaint_requires_start_x():
    js, ts = _schedules(5)
    jax_fn, torch_fn = _toy_models()
    mask, motion = np.ones(SHAPE, bool), np.zeros(SHAPE, np.float32)
    with pytest.raises(AssertionError, match="START_X"):
        JS.ddim_sample_loop(js, jax_fn, SHAPE, jax.random.PRNGKey(0),
                            cfg=JS.SamplerConfig(mean_type=JG.MeanType.EPSILON),
                            inpaint=(jnp.asarray(mask), jnp.asarray(motion)))
    for name in TS.PROGRAMS:
        with pytest.raises(ValueError, match="START_X"):
            TLOOPS[name](ts, torch_fn, SHAPE, None,
                         cfg=TS.SamplerConfig(mean_type=TG.MeanType.EPSILON),
                         inpaint=(torch.from_numpy(mask), torch.from_numpy(motion)))


@pytest.mark.parametrize("name,cfg_kw,expected", [
    ("ddpm", {}, [9, 1]),
    ("ddim", {}, [10]),
    ("ddim", {"eta": 1.0}, [9, 1]),
    ("plms", {"order": 1}, [9, 1]),
    ("plms", {"order": 4}, [1, 1, 1, 6, 1]),
    ("dpmpp", {}, [1, 8, 1]),
])
def test_phases_cover_every_step_once(name, cfg_kw, expected):
    """Steps of one kind share one function (one graph on the card); the
    phases' counts add up to the loop's model calls."""
    _, ts = _schedules(10)
    _, torch_fn = _toy_models()
    calls = []

    def counting_fn(x, t):
        calls.append(int(t[0]))
        return torch_fn(x, t)

    prog = TS.PROGRAMS[name](ts, counting_fn, SHAPE, torch.Generator().manual_seed(0),
                             cfg=TS.SamplerConfig(**cfg_kw))
    assert [p.count for p in prog.phases] == expected
    prog.init()
    prog.run()
    grid = np.asarray(ts.timestep_map).tolist()[::-1]
    if name == "plms" and cfg_kw["order"] > 1:
        grid = [grid[0], grid[1]] + grid[1:]  # the improved-Euler start evaluates twice
    assert calls == grid


def test_program_reruns_from_init():
    """A program is reusable: init() resets x_T and the step index, and a
    rerun gives the first run's numbers (graphs replay the same steps per window)."""
    _, ts = _schedules(10)
    _, torch_fn = _toy_models()
    prog = TS.PROGRAMS["plms"](ts, torch_fn, SHAPE, torch.Generator().manual_seed(0),
                               cfg=TS.SamplerConfig(order=3))
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32))
    prog.init(noise)
    first = prog.run().clone()
    prog.init(noise)
    assert torch.equal(prog.run(), first)
