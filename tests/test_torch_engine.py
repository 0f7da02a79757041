"""Windowed ZEGGS engine of the PyTorch port vs the JAX `ZeggsSampler`.

A tiny real MDM and a tiny WavLM on shared weights (flax init, randomized,
crossed through `models/convert.py`), the same audio, style and injected
per-window x_T: final un-normalized poses agree within 2e-3 relative (the
`PARITY.md` row-24 bar) for DDIM over a 10-step respaced schedule and
DPM-Solver++(2M) over 5 steps, at guidance 0 and 2. Window slicing and
crossfade weights are exact; window buckets leave the output unchanged.
`generate_multi_clip` (3 clips of unequal length, one shorter than a stride)
agrees per clip at the same bar; `transfer_dtype=float16` agrees with the
JAX float16 result within that bar plus one float16 rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.models.wavlm import (
    WavLM as FlaxWavLM,
    WavLMConfig as FlaxWavLMConfig,
    make_zeggs_wavlm_fn as jax_make_zeggs_wavlm_fn,
)
from diffusestylegesture_tpu.sample import engine as jax_engine
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax, wavlm_state_dict_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig, make_zeggs_wavlm_fn
from diffusestylegesture_torch.sample import engine as torch_engine

from torch_port_utils import randomize_flax_params

NJ, N_POSES, N_SEED, WINDOWS = 32, 88, 8, 2
MDM_KW = dict(njoints=NJ, latent_dim=96, ff_size=64, num_layers=2, n_seed=N_SEED)
WAVLM_KW = dict(
    encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=48, encoder_attention_heads=4,
    conv_pos=8, conv_pos_groups=4, num_buckets=40, max_distance=80,
    conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                         (16, 2, 2), (16, 2, 2)),
)


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(WINDOWS * 80 * 800 + 123) * 0.1).astype(np.float32)
    fw = FlaxWavLM(FlaxWavLMConfig(**WAVLM_KW))
    wparams = jax.jit(fw.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16000)))
    wparams = {"params": randomize_flax_params(wparams["params"], 1)}
    fm = FlaxMDM(FlaxMDMConfig(**MDM_KW))
    x = jnp.zeros((1, NJ, 1, N_POSES))
    cond = {"style": jnp.zeros((1, 6)), "seed": x[..., :N_SEED],
            "audio": jnp.zeros((1, N_POSES, WAVLM_KW["encoder_embed_dim"])),
            "mask_local": jnp.ones((1, N_POSES), bool)}
    mparams = jax.jit(fm.init)(jax.random.PRNGKey(2), x, jnp.zeros((1,), jnp.int32), cond)
    mparams = {"params": randomize_flax_params(mparams["params"], 2)}

    wavlm = WavLM(WavLMConfig(**WAVLM_KW)).eval()
    wavlm.load_state_dict(wavlm_state_dict_from_flax(wparams, WavLMConfig(**WAVLM_KW)))
    mdm = MDM(MDMConfig(**MDM_KW, audio_in_dim=WAVLM_KW["encoder_embed_dim"])).eval()
    mdm.load_state_dict(mdm_state_dict_from_flax(mparams))
    stats = dict(mean=rng.standard_normal(NJ).astype(np.float32),
                 std=(0.5 + rng.random(NJ)).astype(np.float32))
    noise = rng.standard_normal((WINDOWS, 1, NJ, 1, N_POSES)).astype(np.float32)
    return dict(audio=audio, fw=fw, wparams=wparams, fm=fm, mparams=mparams, wavlm=wavlm,
                mdm=mdm, stats=stats, noise=noise)


def _torch_sampler(sampler, steps, guidance, **kw):
    betas = TD.named_beta_schedule("cosine", 1000)
    sched = TD.spaced_schedule(betas, TD.space_timesteps(1000, f"ddim{steps}"), device="cpu")
    cfg = torch_engine.ZeggsEngineConfig(njoints=NJ, sampler=sampler, guidance_scale=guidance,
                                         **kw)
    return torch_engine.ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                                     make_zeggs_wavlm_fn(N_POSES), sched, cfg, device="cpu")


@pytest.mark.parametrize("sampler,steps", [("ddim", 10), ("dpmpp", 5)])
@pytest.mark.parametrize("guidance", [0.0, 2.0])
def test_generate_matches_jax(shared, sampler, steps, guidance):
    s = shared
    betas = JD.named_beta_schedule("cosine", 1000)
    jsched = JD.spaced_schedule(betas, JD.space_timesteps(1000, f"ddim{steps}"))
    jcfg = jax_engine.ZeggsEngineConfig(njoints=NJ, sampler=sampler, guidance_scale=guidance)
    jsampler = jax_engine.ZeggsSampler(
        lambda p, x, t, c, uncond=None: s["fm"].apply(p, x, t, c, uncond=uncond),
        jax_make_zeggs_wavlm_fn(s["fw"], N_POSES), jsched, jcfg)
    style = np.array([[0, 0, 1, 0, 0, 0]], np.float32)
    ref = jsampler.generate(s["mparams"], s["wparams"], s["audio"], style, jax.random.PRNGKey(0),
                            noise_windows=s["noise"], **s["stats"])
    out = _torch_sampler(sampler, steps, guidance).generate(
        s["mdm"], s["wavlm"], s["audio"], style, None, noise_windows=s["noise"], **s["stats"])
    assert out.shape == ref.shape == (1, WINDOWS * 80 - N_SEED, NJ)
    scale = max(float(np.abs(ref).mean()), 1.0)
    err = float(np.abs(out - ref).max())
    assert err < 2e-3 * scale, f"max abs err {err} (scale {scale})"


def test_window_buckets_leave_output_unchanged(shared):
    s = shared
    style = np.eye(6, dtype=np.float32)[[0, 4]]
    noise = np.concatenate([s["noise"], s["noise"]], axis=1)
    sampler = _torch_sampler("dpmpp", 5, 0.0)
    plain = sampler.generate(s["mdm"], s["wavlm"], s["audio"], style, None,
                             noise_windows=noise, **s["stats"])
    bucketed = sampler.generate(s["mdm"], s["wavlm"], s["audio"], style, None,
                                noise_windows=noise, window_buckets=(1, 4, 8), **s["stats"])
    np.testing.assert_allclose(bucketed, plain, atol=1e-5)


def test_slice_audio_windows_and_crossfade_exact():
    rng = np.random.default_rng(3)
    for n in (64000 * 3 + 17, 64000 - 1, 64000 * 5):
        audio = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(
            torch_engine.slice_audio_windows(audio, torch_engine.ZeggsEngineConfig()),
            jax_engine.slice_audio_windows(audio, jax_engine.ZeggsEngineConfig()))
    for n_seed, batch, cf in ((8, 1, None), (8, 3, None), (8, 2, 1), (8, 1, 8), (4, 2, 6)):
        for a, b in zip(torch_engine.crossfade_weights(n_seed, batch, cf),
                        jax_engine.crossfade_weights(n_seed, batch, cf)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_unnormalize_matches_jax():
    rng = np.random.default_rng(4)
    seq = rng.standard_normal((2, 5, NJ)).astype(np.float32)
    mean = rng.standard_normal(NJ).astype(np.float32)
    std = rng.random(NJ).astype(np.float32)
    std[::3] = 0.001  # clipped at 0.01
    ref = jax_engine.unnormalize_poses(seq, mean, std)
    np.testing.assert_allclose(torch_engine.unnormalize_poses(seq, mean, std), ref, rtol=1e-6)
    np.testing.assert_allclose(
        torch_engine.unnormalize_poses(torch.from_numpy(seq), mean, std).numpy(), ref, rtol=1e-6)


def _jax_sampler(s, sampler, steps, guidance=0.0):
    betas = JD.named_beta_schedule("cosine", 1000)
    jsched = JD.spaced_schedule(betas, JD.space_timesteps(1000, f"ddim{steps}"))
    jcfg = jax_engine.ZeggsEngineConfig(njoints=NJ, sampler=sampler, guidance_scale=guidance)
    return jax_engine.ZeggsSampler(
        lambda p, x, t, c, uncond=None: s["fm"].apply(p, x, t, c, uncond=uncond),
        jax_make_zeggs_wavlm_fn(s["fw"], N_POSES), jsched, jcfg)


def test_generate_multi_clip_matches_jax(shared):
    s = shared
    audio = s["audio"]
    # 2 windows, 1 window and a clip shorter than one stride (no window)
    audios = [audio, audio[: 80 * 800 + 4000] * 0.5, audio[:30000]]
    styles = np.eye(6, dtype=np.float32)[[0, 3, 5]]
    noise = np.random.default_rng(7).standard_normal(
        (WINDOWS, 3, NJ, 1, N_POSES)).astype(np.float32)
    ref = jax_engine.generate_multi_clip(_jax_sampler(s, "dpmpp", 5), s["mparams"], s["wparams"],
                                         audios, styles, jax.random.PRNGKey(0),
                                         noise_windows=noise, **s["stats"])
    out = torch_engine.generate_multi_clip(_torch_sampler("dpmpp", 5, 0.0), s["mdm"], s["wavlm"],
                                           audios, styles, noise_windows=noise, **s["stats"])
    assert [o.shape for o in out] == [r.shape for r in ref] == [
        (2 * 80 - N_SEED, NJ), (80 - N_SEED, NJ), (0, NJ)]
    for o, r in zip(out[:2], ref[:2]):
        scale = max(float(np.abs(r).mean()), 1.0)
        err = float(np.abs(o - r).max())
        assert err < 2e-3 * scale, f"max abs err {err} (scale {scale})"


def test_transfer_dtype_float16_matches_jax(shared):
    s = shared
    style = np.array([[0, 1, 0, 0, 0, 0]], np.float32)
    ref = _jax_sampler(s, "ddim", 10).generate(
        s["mparams"], s["wparams"], s["audio"], style, jax.random.PRNGKey(0),
        noise_windows=s["noise"], transfer_dtype=jnp.float16, **s["stats"])
    out = _torch_sampler("ddim", 10, 0.0).generate(
        s["mdm"], s["wavlm"], s["audio"], style, None, noise_windows=s["noise"],
        transfer_dtype=torch.float16, **s["stats"])
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, out.astype(np.float16).astype(np.float32))
    scale = max(float(np.abs(ref).mean()), 1.0)
    # one float16 step at |ref| (10 mantissa bits) on top of the engine bar
    assert (np.abs(out - ref) <= 2e-3 * scale + np.abs(ref) * 2.0 ** -10).all()
