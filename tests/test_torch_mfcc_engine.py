"""The MFCC-conditioned ZEGGS engine and stream of the PyTorch port vs the JAX package's.

A tiny `audio_feat='mfcc'` MDM on shared weights (flax init, randomized,
crossed by `models/convert.py`). `make_mfcc_window_fn` (host-side Sphinx
MFCC, 13 cepstra per motion frame) gives the JAX function's features; the
`ZeggsSampler` with it (features computed on the host, copied into the
engine's audio buffer) agrees with the JAX engine's host-feature branch
within 2e-3 relative on a 2-window clip, the JAX draws replayed into the
port's DDPM loop; so does the host-mode `ZeggsStreamSampler` with the JAX
stream over uneven pushes, and for one generator the port's stream equals
the port's batch engine within 1e-5.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.sample import engine as jax_engine
from diffusestylegesture_tpu.sample import streaming as jax_streaming
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.sample import (ZeggsEngineConfig, ZeggsSampler,
                                              ZeggsStreamSampler, make_mfcc_window_fn)

from torch_port_utils import jax_loop_draws, randomize_flax_params, rel_err, replay_draws

NJ, STEPS, CHUNK = 24, 4, 12000
KW = dict(njoints=NJ, latent_dim=96, ff_size=64, num_layers=2, n_seed=8, audio_feat="mfcc")


@functools.lru_cache(maxsize=None)
def _pair():
    fm = FlaxMDM(FlaxMDMConfig(**KW))
    x = jnp.zeros((1, NJ, 1, 88))
    cond = {"style": jnp.zeros((1, 6)), "seed": x[..., :8], "audio": jnp.zeros((1, 88, 13)),
            "mask_local": jnp.ones((1, 88), bool)}
    params = jax.jit(fm.init)(jax.random.PRNGKey(2), x, jnp.zeros((1,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], 2)}
    mdm = MDM(MDMConfig(**KW)).eval()
    mdm.load_state_dict(mdm_state_dict_from_flax(params))
    rng = np.random.default_rng(0)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(2 * 64000 + 5000) / 16000)
             + 0.05 * rng.standard_normal(2 * 64000 + 5000)).astype(np.float32)
    return dict(fm=fm, params=params, mdm=mdm, audio=audio,
                mean=rng.standard_normal(NJ).astype(np.float32),
                std=(0.5 + rng.random(NJ)).astype(np.float32))


def _samplers():
    p = _pair()
    jsched = JD.spaced_schedule(JD.named_beta_schedule("cosine", 1000),
                                JD.space_timesteps(1000, f"ddim{STEPS}"))
    tsched = TD.spaced_schedule(TD.named_beta_schedule("cosine", 1000),
                                TD.space_timesteps(1000, f"ddim{STEPS}"), device="cpu")
    jsampler = jax_engine.ZeggsSampler(
        lambda prm, x, t, c, uncond=None: p["fm"].apply(prm, x, t, c, uncond=uncond),
        jax_engine.make_mfcc_window_fn(88), jsched,
        jax_engine.ZeggsEngineConfig(njoints=NJ, sampler="ddpm"))
    tsampler = ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                            make_mfcc_window_fn(88), tsched,
                            ZeggsEngineConfig(njoints=NJ, sampler="ddpm"), device="cpu")
    return jsampler, tsampler


def test_mfcc_window_fn_matches_jax():
    audio = _pair()["audio"]
    windows = np.stack([audio[:70400], audio[60000:130400]])
    ref = np.asarray(jax_engine.make_mfcc_window_fn(88)(None, windows))
    fn = make_mfcc_window_fn(88)
    out = fn(None, windows)
    assert fn.host_side and out.shape == ref.shape == (2, 88, 13) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_mfcc_sampler_matches_jax(monkeypatch):
    p = _pair()
    jsampler, tsampler = _samplers()
    style = np.eye(6, dtype=np.float32)[[2]]
    key = jax.random.PRNGKey(5)
    ref = jsampler.generate(p["params"], None, p["audio"], style, key, mean=p["mean"],
                            std=p["std"])
    replay_draws(monkeypatch, jax_loop_draws(key, 2, STEPS, (1, NJ, 1, 88)))
    out = tsampler.generate(p["mdm"], None, p["audio"], style, mean=p["mean"], std=p["std"])
    assert out.shape == np.asarray(ref).shape == (1, 2 * 80 - 8, NJ)
    assert rel_err(out, ref) < 2e-3


def _push_all(stream, audio, sizes):
    out, i, k = [], 0, 0
    while i < len(audio):
        n = sizes[k % len(sizes)]
        out += stream.push(audio[i: i + n])
        i, k = i + n, k + 1
    return out


def test_mfcc_stream_matches_jax_stream_and_the_batch_engine(monkeypatch):
    p = _pair()
    jsampler, tsampler = _samplers()
    style = np.eye(6, dtype=np.float32)[[4]]
    key = jax.random.PRNGKey(9)
    jstream = jax_streaming.ZeggsStreamSampler(jsampler, p["params"], None, style, key,
                                               mean=p["mean"], std=p["std"])
    ref = np.concatenate(_push_all(jstream, p["audio"], [CHUNK, 3 * CHUNK + 17]), 1)
    with monkeypatch.context() as m:
        replay_draws(m, jax_loop_draws(key, 2, STEPS, (1, NJ, 1, 88)))
        stream = ZeggsStreamSampler(tsampler, p["mdm"], None, style, None, mean=p["mean"],
                                    std=p["std"])
        out = np.concatenate(_push_all(stream, p["audio"], [CHUNK, 3 * CHUNK + 17]), 1)
    assert out.shape == ref.shape == (1, 152, NJ)
    assert rel_err(out, ref) < 2e-3

    batch = tsampler.generate(p["mdm"], None, p["audio"], style, torch.Generator().manual_seed(3),
                              p["mean"], p["std"])
    stream = ZeggsStreamSampler(tsampler, p["mdm"], None, style, torch.Generator().manual_seed(3),
                                mean=p["mean"], std=p["std"])
    got = np.concatenate(_push_all(stream, p["audio"], [CHUNK]), 1)
    np.testing.assert_allclose(got, batch, atol=1e-5 * max(float(np.abs(batch).mean()), 1.0))
