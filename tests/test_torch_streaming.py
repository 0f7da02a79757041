"""Streaming samplers of the PyTorch port against the JAX streams, on the CPU.

ZEGGS (`ZeggsStreamSampler`, a tiny MDM and WavLM on shared weights) and
BEAT/TWH (`BeatTwhStreamSampler`, a tiny MDMPlus of each variant,
attention3 / 4 / 5, on a ragged and an exact-stride clip) over pushes of
uneven sizes: the JAX stream's DDPM draws (its key split per window, x_T and
one draw a step) are replayed into the port's loop, and the concatenated
motion agrees within 2e-3 relative (the windowed engine's bar). For one
generator the port's stream equals the port's batch engine within 1e-5.
Sessions over one sampler share one window run and interleave without
disturbing each other; `flush()` without a push is empty; a host-side
window function is taken (`test_torch_mfcc_engine.py` holds that mode
against the JAX stream).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models import mdm_plus as jax_mdm_plus
from diffusestylegesture_tpu.models.wavlm import make_zeggs_wavlm_fn as jax_wavlm_fn
from diffusestylegesture_tpu.sample import engine as jax_engine
from diffusestylegesture_tpu.sample import engine_beat as jax_engine_beat
from diffusestylegesture_tpu.sample import streaming as jax_streaming
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.convert import mdm_plus_state_dict_from_flax
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig
from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
from diffusestylegesture_torch.sample import engine_beat as torch_engine_beat
from diffusestylegesture_torch.sample import (
    BeatTwhSampler,
    BeatTwhStreamSampler,
    ZeggsEngineConfig,
    ZeggsSampler,
    ZeggsStreamSampler,
)

from torch_port_utils import (
    ZEGGS_TINY_NJ,
    jax_loop_draws,
    randomize_flax_params,
    rel_err,
    replay_draws,
    zeggs_tiny_pair,
)

STEPS = 6
CHUNK = 8000  # 0.5 s of 16 kHz audio


def _apply(m, x, t, c, uncond=None):
    return m(x, t, c, uncond=uncond)


def _torch_sched():
    return TD.spaced_schedule(TD.named_beta_schedule("cosine", 1000),
                              TD.space_timesteps(1000, f"ddim{STEPS}"), device="cpu")


def _jax_sched():
    return JD.spaced_schedule(JD.named_beta_schedule("cosine", 1000),
                              JD.space_timesteps(1000, f"ddim{STEPS}"))


def _push_all(stream, data, sizes):
    out, i, k = [], 0, 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        out += stream.push(data[i: i + n])
        i, k = i + n, k + 1
    return out


@pytest.fixture(scope="module")
def zeggs():
    pair = zeggs_tiny_pair(0)
    rng = np.random.default_rng(1)
    pair["audio"] = (rng.standard_normal(2 * 64000 + 5000) * 0.1).astype(np.float32)
    return pair


def _zeggs_sampler(sampler="ddpm"):
    return ZeggsSampler(_apply, make_zeggs_wavlm_fn(88), _torch_sched(),
                        ZeggsEngineConfig(njoints=ZEGGS_TINY_NJ, sampler=sampler), device="cpu")


def test_zeggs_stream_matches_jax_stream(zeggs, monkeypatch):
    z = zeggs
    style = np.eye(6, dtype=np.float32)[[3]]
    jsampler = jax_engine.ZeggsSampler(
        lambda p, x, t, c, uncond=None: z["fm"].apply(p, x, t, c, uncond=uncond),
        jax_wavlm_fn(z["fw"], 88), _jax_sched(),
        jax_engine.ZeggsEngineConfig(njoints=ZEGGS_TINY_NJ, sampler="ddpm"))
    key = jax.random.PRNGKey(3)
    jstream = jax_streaming.ZeggsStreamSampler(jsampler, z["mparams"], z["wparams"], style, key,
                                               mean=z["mean"], std=z["std"])
    ref = _push_all(jstream, z["audio"], [CHUNK, 3 * CHUNK + 17])
    replay_draws(monkeypatch, jax_loop_draws(key, 2, STEPS, (1, ZEGGS_TINY_NJ, 1, 88)))
    stream = ZeggsStreamSampler(_zeggs_sampler(), z["mdm"], z["wavlm"], style, None,
                                mean=z["mean"], std=z["std"])
    out = _push_all(stream, z["audio"], [CHUNK, 3 * CHUNK + 17])
    assert [o.shape for o in out] == [r.shape for r in ref] == [(1, 72, ZEGGS_TINY_NJ),
                                                               (1, 80, ZEGGS_TINY_NJ)]
    assert stream.frames_emitted == jstream.frames_emitted == 152
    assert rel_err(np.concatenate(out, 1), np.concatenate(ref, 1)) < 2e-3


def test_zeggs_stream_equals_batch_engine_and_sessions_share_one_run(zeggs):
    z = zeggs
    sampler = _zeggs_sampler()
    styles = np.eye(6, dtype=np.float32)[[1, 5]]
    batch = [sampler.generate(z["mdm"], z["wavlm"], z["audio"], s[None],
                              torch.Generator().manual_seed(7 + i), z["mean"], z["std"])
             for i, s in enumerate(styles)]
    streams = [ZeggsStreamSampler(sampler, z["mdm"], z["wavlm"], s,
                                  torch.Generator().manual_seed(7 + i), mean=z["mean"],
                                  std=z["std"]) for i, s in enumerate(styles)]
    outs = [[], []]
    for i in range(0, len(z["audio"]), CHUNK):  # two sessions, interleaved
        for k, stream in enumerate(streams):
            outs[k] += stream.push(z["audio"][i: i + CHUNK])
    assert len(sampler._runs) == 1
    for out, ref in zip(outs, batch):
        got = np.concatenate(out, 1)
        assert got.shape == ref.shape == (1, 152, ZEGGS_TINY_NJ)
        np.testing.assert_allclose(got, ref, atol=1e-5 * max(float(np.abs(ref).mean()), 1.0))


def test_zeggs_stream_keeps_short_tails_and_refuses_host_features(zeggs):
    z = zeggs
    stream = ZeggsStreamSampler(_zeggs_sampler(), z["mdm"], z["wavlm"], np.eye(6)[0], None)
    assert stream.push(z["audio"][:63999]) == [] and stream.frames_emitted == 0

    def mfcc_fn(_p, windows):
        return windows

    mfcc_fn.host_side = True
    host = ZeggsSampler(_apply, mfcc_fn, _torch_sched(), ZeggsEngineConfig(njoints=ZEGGS_TINY_NJ),
                        device="cpu")
    # host-side window features are taken now (the MFCC mode); a short tail
    # stays buffered there too
    host_stream = ZeggsStreamSampler(host, z["mdm"], None, np.eye(6)[0], None)
    assert host_stream.push(z["audio"][:63999]) == [] and host_stream.frames_emitted == 0


NJ, N_POSES, N_SEED, AUDIO, STYLE = 36, 30, 5, 40, 4
BEAT_KW = dict(njoints=NJ, latent_dim=96, ff_size=64, num_layers=2, source_audio_dim=AUDIO,
               audio_feat_dim=32, style_dim_in=STYLE, n_seed=N_SEED, window_size=15)
VARIANTS = ["attention3", "attention4", "attention5"]


@functools.lru_cache(maxsize=None)
def _beat(variant):
    rng = np.random.default_rng(0)
    mode = f"cross_local_attention{variant[-1]}_style1"
    fm = jax_mdm_plus.MDMPlus(jax_mdm_plus.MDMPlusConfig(**BEAT_KW, cond_mode=mode))
    a_len = N_POSES - N_SEED * (int(variant[-1]) - 3)
    cond = {"style": jnp.zeros((1, STYLE)), "seed": jnp.zeros((1, NJ, 1, N_SEED)),
            "audio": jnp.zeros((1, a_len, AUDIO)), "mask_local": jnp.ones((1, N_POSES), bool)}
    if variant == "attention5":
        cond["seed_last"] = cond["seed"]
    params = jax.jit(fm.init)(jax.random.PRNGKey(2), jnp.zeros((1, NJ, 1, N_POSES)),
                              jnp.zeros((1,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], 2)}
    model = MDMPlus(MDMPlusConfig(**BEAT_KW, cond_mode=mode)).eval()
    model.load_state_dict(mdm_plus_state_dict_from_flax(params))
    motion_dim = NJ // 3
    raw = rng.standard_normal((N_SEED + 2, motion_dim)).astype(np.float32)
    mean = rng.standard_normal(motion_dim).astype(np.float32)
    std = (0.5 + rng.random(motion_dim)).astype(np.float32)
    return dict(fm=fm, params=params, model=model, mean=mean, std=std,
                textaudio=rng.standard_normal((60, AUDIO)).astype(np.float32),
                seed=jax_engine_beat.prepare_seed_gesture(raw, mean, std),
                seed_last=(rng.standard_normal((N_SEED, NJ)).astype(np.float32)
                           if variant == "attention5" else None))


def _beat_cfg(module, variant):
    return module.BeatEngineConfig(n_poses=N_POSES, n_seed=N_SEED, njoints=NJ, audio_dim=AUDIO,
                                   variant=variant, sampler="ddpm")


def _beat_sampler(variant):
    return BeatTwhSampler(_apply, _torch_sched(), _beat_cfg(torch_engine_beat, variant),
                          device="cpu")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("real_n", [60, 50], ids=["ragged", "exact_stride"])
def test_beat_stream_matches_jax_stream(variant, real_n, monkeypatch):
    b = _beat(variant)
    feats = b["textaudio"][:real_n]
    style = np.eye(STYLE, dtype=np.float32)[[2]]
    jsampler = jax_engine_beat.BeatTwhSampler(
        lambda p, x, t, c, uncond=None: b["fm"].apply(p, x, t, c, uncond=uncond), _jax_sched(),
        _beat_cfg(jax_engine_beat, variant))
    key = jax.random.PRNGKey(5)
    jstream = jax_streaming.BeatTwhStreamSampler(jsampler, b["params"], b["seed"], style, key,
                                                 b["mean"], b["std"], seed_last=b["seed_last"])
    ref = _push_all(jstream, feats, [7, 19]) + jstream.flush()
    windows = -(-real_n // (N_POSES - N_SEED))
    replay_draws(monkeypatch, jax_loop_draws(key, windows, STEPS, (1, NJ, 1, N_POSES)))
    stream = BeatTwhStreamSampler(_beat_sampler(variant), b["model"], b["seed"], style, None,
                                  b["mean"], b["std"], seed_last=b["seed_last"])
    out = _push_all(stream, feats, [7, 19]) + stream.flush()
    assert [o.shape for o in out] == [r.shape for r in ref]
    got, want = np.concatenate(out, 1), np.concatenate(ref, 1)
    assert got.shape == (1, real_n, NJ // 3)
    assert rel_err(got, want) < 2e-3


@pytest.mark.parametrize("variant", VARIANTS)
def test_beat_stream_equals_batch_engine(variant):
    b = _beat(variant)
    sampler = _beat_sampler(variant)
    style = np.eye(STYLE, dtype=np.float32)[[1]]
    ref = sampler.generate(b["model"], b["textaudio"], b["seed"], style,
                           torch.Generator().manual_seed(9), b["mean"], b["std"],
                           seed_last=b["seed_last"])
    stream = BeatTwhStreamSampler(sampler, b["model"], b["seed"], style,
                                  torch.Generator().manual_seed(9), b["mean"], b["std"],
                                  seed_last=b["seed_last"])
    out = _push_all(stream, b["textaudio"], [11]) + stream.flush()
    got = np.concatenate(out, 1)
    assert got.shape == ref.shape == (1, 60, NJ // 3)
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(float(np.abs(ref).mean()), 1.0))
    assert len(sampler._runs) == 1


def test_beat_flush_without_push_is_empty_and_attention5_needs_seed_last():
    b = _beat("attention5")
    sampler = _beat_sampler("attention5")
    style = np.eye(STYLE, dtype=np.float32)[[0]]
    stream = BeatTwhStreamSampler(sampler, b["model"], b["seed"], style, None, b["mean"],
                                  b["std"], seed_last=b["seed_last"])
    assert stream.flush() == []
    with pytest.raises(ValueError, match="seed_last"):
        BeatTwhStreamSampler(sampler, b["model"], b["seed"], style, None, b["mean"], b["std"])
