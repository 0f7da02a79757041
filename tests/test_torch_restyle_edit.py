"""DDIM inversion, re-styling and inpainting edits of the PyTorch port vs the JAX
package, on the CPU, at the sizes of `tests/test_engine.py` (TestRestyle,
TestEditing).

The denoiser is the analytically optimal one for Gaussian data with a
style-dependent mean (TestRestyle's), written once for each framework, so the
comparison holds the loops' bookkeeping, not a network: one
`ddim_reverse_sample` step at several t and the whole
`ddim_reverse_sample_loop` within 1e-5; `restyle_window` at strength 1.0 and
0.5 within 1e-5 (and the JAX tests' round-trip and style-transfer
properties); `in_between_mask` and `feature_mask` exactly; `edit_motion` with
the JAX loop's draws replayed within 1e-5, the kept regions equal to the
reference motion.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.diffusion import gaussian as JG
from diffusestylegesture_tpu.sample import edit as jax_edit
from diffusestylegesture_tpu.sample import restyle as jax_restyle
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.diffusion import gaussian as TG
from diffusestylegesture_torch.sample import edit as torch_edit
from diffusestylegesture_torch.sample import restyle_window

from torch_port_utils import np32

NJ, T, S2 = 12, 16, 0.16


def _jax_model(sched):
    def model_apply(x, t, cond):
        ab = JG._bcast(sched.alphas_cumprod, t, x.ndim)
        mu = jnp.sum(cond["style"], axis=-1)[:, None, None, None] * 0.2
        return (S2 * jnp.sqrt(ab) * x + (1 - ab) * mu) / (ab * S2 + (1 - ab))
    return model_apply


def _torch_model(sched):
    def model_apply(x, t, cond):
        ab = TG._bcast(sched.alphas_cumprod, t, x.ndim)
        mu = torch.sum(cond["style"], dim=-1)[:, None, None, None] * 0.2
        return (S2 * torch.sqrt(ab) * x + (1 - ab) * mu) / (ab * S2 + (1 - ab))
    return model_apply


def _scheds(n):
    return (JD.Schedule.create(JD.named_beta_schedule("cosine", n)),
            TD.Schedule.create(TD.named_beta_schedule("cosine", n), device="cpu"))


def _motion(seed, B=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, NJ, 1, T)) * np.sqrt(S2)).astype(np.float32)


def _close(out, ref, tol=1e-5):
    out, ref = np32(out), np32(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * max(float(np.abs(ref).mean()), 1.0))


def test_ddim_reverse_sample_and_loop_match_jax():
    js, ts = _scheds(32)
    x = _motion(20)
    style = np.ones((2, 6), np.float32)
    jm = lambda xx, tt: _jax_model(js)(xx, tt, {"style": jnp.asarray(style)})  # noqa: E731
    tm = lambda xx, tt: _torch_model(ts)(xx, tt, {"style": torch.from_numpy(style)})  # noqa: E731
    for i in (0, 7, 31):
        ref = JD.ddim_reverse_sample(js, jm, jnp.asarray(x), jnp.full((2,), i, jnp.int32))
        out = TD.ddim_reverse_sample(ts, tm, torch.from_numpy(x), torch.full((2,), i))
        _close(out, ref)
    _close(TD.ddim_reverse_sample_loop(ts, tm, torch.from_numpy(x)),
           JD.ddim_reverse_sample_loop(js, jm, jnp.asarray(x)))


@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_restyle_window_matches_jax(strength):
    js, ts = _scheds(64)
    motion = _motion(22)
    cond_a = np.zeros((2, 6), np.float32)
    cond_b = np.ones((2, 6), np.float32)
    ref = jax_restyle.restyle_window(js, _jax_model(js), jnp.asarray(motion),
                                     {"style": jnp.asarray(cond_a)}, {"style": jnp.asarray(cond_b)},
                                     strength=strength)
    out = restyle_window(ts, _torch_model(ts), torch.from_numpy(motion),
                         {"style": torch.from_numpy(cond_a)}, {"style": torch.from_numpy(cond_b)},
                         strength=strength)
    _close(out, ref)


def test_restyle_round_trip_and_style_transfer():
    """The JAX tests' properties on the port: the round trip under one style
    converges with the step count, another style moves the mean, and partial
    strength moves it less."""
    motion = torch.from_numpy(_motion(21))
    cond = {"style": torch.zeros((2, 6))}
    errs = {}
    for n in (32, 128):
        ts = _scheds(n)[1]
        out = restyle_window(ts, _torch_model(ts), motion, cond, cond)
        errs[n] = float((out - motion).abs().mean() / motion.abs().mean())
    assert errs[32] < 0.15 and errs[128] < 0.35 * errs[32]
    ts = _scheds(64)[1]
    full = restyle_window(ts, _torch_model(ts), motion, cond, {"style": torch.ones((2, 6))})
    part = restyle_window(ts, _torch_model(ts), motion, cond, {"style": torch.ones((2, 6))},
                          strength=0.25)
    assert float(full.mean()) > 0.3 and float(part.mean()) < float(full.mean())
    with pytest.raises(ValueError, match="strength"):
        restyle_window(ts, _torch_model(ts), motion, cond, cond, strength=0.0)


@pytest.mark.parametrize("shape,prefix,suffix", [((1, NJ, 1, 24), 6, 4), ((2, NJ, 1, 24), 5, 0)])
def test_masks_exact(shape, prefix, suffix):
    np.testing.assert_array_equal(
        torch_edit.in_between_mask(shape, prefix, suffix, device="cpu").numpy(),
        np.asarray(jax_edit.in_between_mask(shape, prefix, suffix)))
    for keep in (range(3), (), torch_edit.ZEGGS_ROOT_CHANNELS[:5]):
        np.testing.assert_array_equal(
            torch_edit.feature_mask(shape, keep, device="cpu").numpy(),
            np.asarray(jax_edit.feature_mask(shape, keep)))
    assert torch_edit.ZEGGS_ROOT_CHANNELS == jax_edit.ZEGGS_ROOT_CHANNELS


def _edit_draws(key, steps, shape):
    """The JAX DDPM loop's draws for `key`: x_T from the init subkey, then one a step."""
    key, init_key = jax.random.split(key)
    draws = [np.array(jax.random.normal(init_key, shape, jnp.float32))]
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        draws.append(np.array(jax.random.normal(nkey, shape, jnp.float32)))
    return iter(draws)


@pytest.mark.parametrize("kind", ["in_between", "feature"])
def test_edit_motion_matches_jax(kind, monkeypatch):
    from diffusestylegesture_torch.diffusion.sampling import SampleProgram

    js, ts = _scheds(8)
    shape = (1, NJ, 1, 24)
    ref_motion = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if kind == "in_between":
        jmask, tmask = (jax_edit.in_between_mask(shape, 6, 4),
                        torch_edit.in_between_mask(shape, 6, 4, device="cpu"))
    else:
        jmask, tmask = (jax_edit.feature_mask(shape, range(3)),
                        torch_edit.feature_mask(shape, range(3), device="cpu"))
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jax_edit.edit_motion(js, lambda x, t: 0.3 * x, jnp.asarray(ref_motion), jmask,
                                          key))
    draws = _edit_draws(key, 8, shape)
    monkeypatch.setattr(SampleProgram, "_randn", lambda self: torch.from_numpy(next(draws)))
    out = torch_edit.edit_motion(ts, lambda x, t: 0.3 * x, torch.from_numpy(ref_motion), tmask)
    _close(out, ref)
    kept = tmask.numpy()
    np.testing.assert_allclose(out.numpy()[kept], ref_motion[kept], atol=1e-6)
    assert np.abs(out.numpy()[~kept] - ref_motion[~kept]).max() > 1e-3
