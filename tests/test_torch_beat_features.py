"""BEAT/TWH host features of the PyTorch port vs the JAX package.

The port keeps its own copies of the JAX package's numpy feature code
(`audio/praat_pitch.py`, `audio/features.py`, `data/text.py`,
`data/beat_twh.py::load_audio_features`). On seeded signals (a harmonic
tone, a vibrato, noise, silence) the praat pitch and intensity tracks, MFCC,
log-mel, prosody and onset flags agree with the JAX functions within 1e-6
abs: the same numpy arithmetic, so any larger gap would be a fault. So do
the fused 1133-d audio rows, with and without WavLM features (interpolated by
the port's `interpolate_linear` instead of jnp), and the 301/302-d text rows
from a synthetic tsv and `.vec` file. `make_twh_wavlm_fn` agrees with the JAX
adapter at a small WavLM within atol 1e-4 (`tests/test_torch_wavlm.py`'s bar),
including the extra all-zero chunk of a wav of exactly 5 s.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.audio import features as jax_af
from diffusestylegesture_tpu.audio import praat_pitch as jax_praat
from diffusestylegesture_tpu.data import beat_twh as jax_beat_twh
from diffusestylegesture_tpu.data import text as jax_text
from diffusestylegesture_tpu.models.wavlm import (
    WavLM as FlaxWavLM,
    WavLMConfig as FlaxWavLMConfig,
    make_twh_wavlm_fn as jax_make_twh_wavlm_fn,
)
from diffusestylegesture_torch.audio import features as af
from diffusestylegesture_torch.audio import praat_pitch as praat
from diffusestylegesture_torch.data import beat_twh, text
from diffusestylegesture_torch.models.convert import wavlm_state_dict_from_flax
from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig, make_twh_wavlm_fn

from test_torch_isolation import TINY_WAVLM
from torch_port_utils import np32, randomize_flax_params

SR = 16000
ATOL = 1e-6


def _signal(kind, seconds=1.2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    if kind == "tone":
        return sum(0.3 / k * np.sin(2 * np.pi * 180 * k * t + rng.uniform(0, 6)) for k in (1, 2, 3))
    if kind == "vibrato":
        return 0.4 * np.sin(2 * np.pi * (220 * t + 8 * np.sin(2 * np.pi * 5 * t)))
    if kind == "noise":
        return 0.1 * rng.standard_normal(t.shape)
    return np.zeros_like(t)


SIGNALS = ["tone", "vibrato", "noise", "silence"]


@pytest.mark.parametrize("kind", SIGNALS)
def test_praat_pitch_and_intensity_tracks(kind):
    y = _signal(kind)
    for fn in ("sound_to_pitch_ac", "sound_to_intensity"):
        ours = getattr(praat, fn)(y, SR, 1.0 / 300.0)
        theirs = getattr(jax_praat, fn)(y, SR, 1.0 / 300.0)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=fn)
    times = np.linspace(0.0, 1.1, 57)
    ptimes, pfreqs = praat.sound_to_pitch_ac(y, SR, 1.0 / 300.0)
    np.testing.assert_allclose(praat.pitch_value_at_time(ptimes, pfreqs, times),
                               jax_praat.pitch_value_at_time(ptimes, pfreqs, times), atol=ATOL)
    itimes, ivals = praat.sound_to_intensity(y, SR, 1.0 / 300.0)
    np.testing.assert_allclose(praat.intensity_value_at_time(itimes, ivals, times),
                               jax_praat.intensity_value_at_time(itimes, ivals, times),
                               atol=ATOL)


@pytest.mark.parametrize("kind", SIGNALS)
@pytest.mark.parametrize("fn", ["mfcc", "log_melspectrogram", "prosodic_features"])
def test_frame_features(kind, fn):
    y = _signal(kind, seed=1).astype(np.float32)
    ours, theirs = getattr(af, fn)(y, SR), getattr(jax_af, fn)(y, SR)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_allclose(ours, theirs, atol=ATOL)


@pytest.mark.parametrize("kind", SIGNALS + ["clicks"])
def test_onset_flags(kind):
    if kind == "clicks":
        y = np.zeros(int(SR * 1.5))
        y[[2000, 9000, 17000]] = 1.0
    else:
        y = _signal(kind, seed=2)
    np.testing.assert_array_equal(af.onset_flags(y, SR, 36), jax_af.onset_flags(y, SR, 36))


@pytest.mark.parametrize("with_wavlm", [False, True], ids=["zeros", "wavlm"])
def test_load_audio_features(with_wavlm):
    y = _signal("vibrato", seconds=1.5, seed=3).astype(np.float32)
    wavlm = (np.random.default_rng(4).standard_normal((74, 1024)).astype(np.float32)
             if with_wavlm else None)
    ours = beat_twh.load_audio_features(y, SR, wavlm)
    theirs = jax_beat_twh.load_audio_features(y, SR, wavlm)
    assert ours.shape == theirs.shape and ours.shape[1] == 1133 and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=ATOL)


@pytest.fixture
def tsv_and_vectors(tmp_path):
    rng = np.random.default_rng(6)
    words = ["hello", "world", "big", "laugh"]
    vectors = {w: rng.standard_normal(300) for w in words}
    vec = tmp_path / "words.vec"
    with open(vec, "w", encoding="utf-8") as f:
        f.write(f"{len(words)} 300\n")
        for w in words:
            f.write(w + " " + " ".join(f"{v:.6f}" for v in vectors[w]) + "\n")
        f.write("broken 1.0 2.0\n")  # a line of the wrong width is skipped
    tsv = tmp_path / "clip.tsv"
    tsv.write_text("0.10\t0.55\tHello,\n0.60\t1.20\tbig world\n1.30\t1.70\t#laugh#\n"
                   "1.80\t2.00\tunknown\nnot a row\n")
    return str(tsv), str(vec)


def test_load_word_vectors_and_tsv(tsv_and_vectors, tmp_path):
    tsv, vec = tsv_and_vectors
    ours, theirs = text.load_word_vectors(vec), jax_text.load_word_vectors(vec)
    assert sorted(ours) == sorted(theirs) == ["big", "hello", "laugh", "world"]
    for w in ours:
        np.testing.assert_array_equal(ours[w], theirs[w])
    cached = text.load_word_vectors(vec, cache=str(tmp_path / "cache.npz"))
    again = text.load_word_vectors("missing.vec", cache=str(tmp_path / "cache.npz"))
    for w in cached:
        np.testing.assert_allclose(again[w], cached[w], atol=1e-6)
    assert text.load_tsv_unclipped(tsv) == jax_text.load_tsv_unclipped(tsv)
    for laughter in (False, True):
        a = text.load_tsv(tsv, ours, 70, laughter_flag=laughter)
        b = jax_text.load_tsv(tsv, theirs, 70, laughter_flag=laughter)
        assert a.shape == (70, 302 if laughter else 301)
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def wavlms():
    fw = FlaxWavLM(FlaxWavLMConfig(**TINY_WAVLM))
    params = jax.jit(fw.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16000)))
    params = {"params": randomize_flax_params(params["params"], 1)}
    model = WavLM(WavLMConfig(**TINY_WAVLM)).eval()
    model.load_state_dict(wavlm_state_dict_from_flax(params, WavLMConfig(**TINY_WAVLM)))
    return fw, params, model


@pytest.mark.parametrize("seconds", [5.0, 6.3], ids=["exact_5s", "6.3s"])
def test_twh_wavlm_adapter_matches_jax(wavlms, seconds):
    fw, params, model = wavlms
    wav = (0.2 * np.random.default_rng(8).standard_normal(int(SR * seconds))).astype(np.float32)
    ref = np.asarray(jax_make_twh_wavlm_fn(fw)(params, jnp.asarray(wav)))
    with torch.no_grad():
        out = np32(make_twh_wavlm_fn()(model, torch.from_numpy(wav)))
    # 5 s → two 5 s chunks (the second all zeros), 6.3 s → two: 249 frames each
    assert out.shape == ref.shape == (2 * 249, TINY_WAVLM["encoder_embed_dim"])
    np.testing.assert_allclose(out, ref, atol=1e-4)
