"""WavLM of the PyTorch port vs the flax WavLM (tiny configurations).

Parameters cross through `models/convert.py::wavlm_state_dict_from_flax`;
features agree at atol 1e-4 in both extractor modes (float32 through
layer norms and a softmax over ~50 frames). `relative_position_bucket` is
exact; `interpolate_linear` and the ZEGGS adapter agree at 1e-6; the
reference-layout checkpoint loader folds the pos-conv weight norm.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.models.wavlm import (
    WavLM as FlaxWavLM,
    WavLMConfig as FlaxWavLMConfig,
    interpolate_linear as jax_interpolate_linear,
    make_zeggs_wavlm_fn as jax_make_zeggs_wavlm_fn,
)
from diffusestylegesture_tpu.models.wavlm.model import (
    relative_position_bucket as jax_relative_position_bucket,
)
from diffusestylegesture_torch.models.convert import load_wavlm_checkpoint, wavlm_state_dict_from_flax
from diffusestylegesture_torch.models.wavlm import (
    WavLM,
    WavLMConfig,
    interpolate_linear,
    make_zeggs_wavlm_fn,
    relative_position_bucket,
)

from torch_port_utils import np32, randomize_flax_params

SMALL = dict(
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=96, encoder_attention_heads=4,
    conv_pos=16, conv_pos_groups=4, num_buckets=40, max_distance=80,
    conv_feature_layers=((24, 10, 5), (24, 3, 2), (24, 3, 2), (24, 3, 2), (24, 3, 2),
                         (24, 2, 2), (24, 2, 2)),
)
BASE_LIKE = dict(extractor_mode="default", layer_norm_first=False, normalize=False)


def _pair(extra, seed=0, S=16000):
    fcfg, tcfg = FlaxWavLMConfig(**SMALL, **extra), WavLMConfig(**SMALL, **extra)
    wav = (np.random.default_rng(seed).standard_normal((2, S)) * 0.3).astype(np.float32)
    fmodel = FlaxWavLM(fcfg)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.asarray(wav))
    params = {"params": randomize_flax_params(params["params"], seed)}
    model = WavLM(tcfg).eval()
    model.load_state_dict(wavlm_state_dict_from_flax(params, tcfg))
    return fmodel, params, model, wav


@pytest.mark.parametrize("extra", [{}, BASE_LIKE], ids=["layer_norm", "default"])
def test_features_match_flax(extra):
    fmodel, params, model, wav = _pair(extra)
    ref = np.asarray(fmodel.apply(params, jnp.asarray(wav)))
    with torch.no_grad():
        out = np32(model(torch.from_numpy(wav)))
    assert out.shape == ref.shape == (2, 49, 64)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_relative_position_bucket_exact():
    rel = np.arange(-900, 901)[None, :] - np.arange(0, 5)[:, None]
    for nb, md in ((320, 800), (40, 80)):
        ref = np.asarray(jax_relative_position_bucket(jnp.asarray(rel), nb, md))
        out = relative_position_bucket(torch.from_numpy(rel), nb, md).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("T,size", [(49, 88), (274, 88), (1, 5)])
def test_interpolate_linear_matches_jax(T, size):
    x = np.random.default_rng(T).standard_normal((3, T, 7)).astype(np.float32)
    np.testing.assert_allclose(np32(interpolate_linear(torch.from_numpy(x), size)),
                               np.asarray(jax_interpolate_linear(jnp.asarray(x), size)),
                               atol=1e-6)


def test_zeggs_adapter_matches_jax_and_skips_wav_normalisation():
    fmodel, params, model, wav = _pair({}, seed=3, S=22400)
    wav = wav + 0.2  # an offset a wav layer-norm would remove
    ref = np.asarray(jax_make_zeggs_wavlm_fn(fmodel, 88)(params, jnp.asarray(wav)))
    with torch.no_grad():
        out = np32(make_zeggs_wavlm_fn(88)(model, torch.from_numpy(wav)))
        raw = np32(interpolate_linear(model(torch.from_numpy(wav)), 88))
    assert out.shape == (2, 88, 64)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_array_equal(out, raw)  # the raw wav goes to the encoder


def test_checkpoint_loader_folds_weight_norm(tmp_path):
    _, _, model, wav = _pair({}, seed=4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    w = sd.pop("encoder.pos_conv.0.weight")
    g = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_g"] = 2.0 * g  # fold must scale by g/‖v‖
    sd["encoder.pos_conv.0.weight_v"] = w
    sd["mask_emb"] = torch.zeros(64)  # pretraining-only keys are dropped
    cfg = {k: v for k, v in SMALL.items()}
    cfg["conv_feature_layers"] = repr([tuple(t) for t in SMALL["conv_feature_layers"]])
    torch.save({"cfg": cfg, "model": sd}, tmp_path / "w.pt")
    tcfg, loaded = load_wavlm_checkpoint(str(tmp_path / "w.pt"), device="cpu")
    assert tcfg == WavLMConfig(**SMALL)
    np.testing.assert_allclose(np32(loaded.state_dict()["encoder.pos_conv.0.weight"]),
                               2.0 * np32(w), rtol=1e-5, atol=1e-6)
