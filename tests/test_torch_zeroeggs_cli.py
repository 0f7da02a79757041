"""ZeroEGGS CLI of the PyTorch port (`cli/zeroeggs.py`) against the JAX CLI, on the CPU.

Two seeded 4 s wav + BVH pairs (`tests/test_data_cli.py::write_synth_pair`):
`prepare` writes the JAX CLI's features.npz and stats.npz within 1e-6;
`train` runs a few RAdam steps at small widths from one seed (finite losses,
config.json with the JAX CLI's keys, model.pt); `generate` on the JAX CLI's
own trained save dir, converted by `scripts/convert_orbax_to_torch.py`, with
the JAX CLI's style draws (its key split per example) handed to the VAE,
writes BVH values within 1e-4 of the JAX CLI's, relative to the largest
value (angles modulo 360°; the first frame within 1e-4 degrees), for the gru
and attn style encoders and the add and stitch blends. The
`data/zeroeggs_data.py` helpers match the JAX module exactly.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from test_data_cli import write_synth_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--hidden_size", "32", "--speech_encoding_size", "8", "--style_embedding_size", "4",
         "--num_rnn_layers", "1"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    src = tmp_path_factory.mktemp("raw")
    write_synth_pair(str(src), "001_Happy_0_x_1_0", seconds=4.0, seed=0)
    write_synth_pair(str(src), "002_Sad_0_x_1_0", seconds=4.0, seed=1)
    return src


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * max(float(np.abs(ref).max()), 1.0))


def test_prepare_matches_jax(clips, tmp_path):
    from diffusestylegesture_torch.cli import zeroeggs as torch_cli
    from diffusestylegesture_tpu.cli import zeroeggs as jax_cli

    jax_cli.main(["prepare", "--source", str(clips), "--target", str(tmp_path / "jax")])
    res = torch_cli.main(["prepare", "--source", str(clips), "--target", str(tmp_path / "t")])
    assert res["clips"] == 2
    for name in ("features.npz", "stats.npz"):
        ref, out = np.load(tmp_path / "jax" / name), np.load(tmp_path / "t" / name)
        assert sorted(ref.files) == sorted(out.files)
        for k in ref.files:
            if ref[k].dtype.kind in "US":
                np.testing.assert_array_equal(out[k], ref[k])
            else:
                _close(out[k], ref[k], 1e-6)
    stats = np.load(tmp_path / "t" / "stats.npz")
    assert stats["anim_input_mean"].shape == (1134,) and stats["anim_output_mean"].shape == (1131,)


def test_data_helpers_match_jax():
    from diffusestylegesture_torch.data import zeroeggs_data as T
    from diffusestylegesture_tpu.data import zeroeggs_data as J

    rng = np.random.default_rng(0)
    audio = rng.standard_normal(16000 * 2).astype(np.float32) * 0.1
    for kw in ({}, {"pre_emphasis": False, "include_energy": False}):
        np.testing.assert_array_equal(T.audio_features(audio, 16000, 60.0, 121, **kw),
                                      J.audio_features(audio, 16000, 60.0, 121, **kw))
    for a, b in zip(T.window_index([(0, 30), (40, 52)], [1, 0], 3, 8),
                    J.window_index([(0, 30), (40, 52)], [1, 0], 3, 8)):
        np.testing.assert_array_equal(a, b)
    arrays = {"x": rng.standard_normal((50, 4)).astype(np.float32)}
    for k, v in J.feature_statistics(arrays).items():
        np.testing.assert_array_equal(T.feature_statistics(arrays)[k], v)


@pytest.fixture(scope="module")
def prepared(clips, tmp_path_factory):
    from diffusestylegesture_torch.cli import zeroeggs as torch_cli

    data = tmp_path_factory.mktemp("prepared")
    torch_cli.main(["prepare", "--source", str(clips), "--target", str(data)])
    return data


def test_train_runs_from_one_seed(prepared, tmp_path, capsys):
    from diffusestylegesture_torch.cli import zeroeggs as torch_cli

    runs = []
    for name in ("a", "b"):
        runs.append(torch_cli.main(["train", "--data", str(prepared), "--save_dir",
                                    str(tmp_path / name), "--num_steps", "4", "--batch_size", "2",
                                    "--window", "8", "--device", "cpu"] + SMALL))
    assert runs[0]["losses"] == runs[1]["losses"] and all(np.isfinite(runs[0]["losses"]))
    assert len(runs[0]["step_seconds"]) == 4
    with open(tmp_path / "a" / "config.json") as f:
        cfg = json.load(f)
    assert set(cfg) == {"hidden_size", "speech_encoding_size", "style_embedding_size",
                        "num_rnn_layers", "style_encoder_type", "audio_dim"}
    sd = torch.load(tmp_path / "a" / "model.pt", weights_only=True)
    assert {k.split(".")[0] for k in sd} == {"speech", "style", "decoder"}
    assert "step 0: loss" in capsys.readouterr().out


def _bvh_values(path):
    with open(path) as f:
        motion = f.read().split("Frame Time:")[1].splitlines()[1:]
    return np.array([[float(v) for v in row.split()] for row in motion if row.strip()])


@pytest.mark.parametrize("encoder,blend", [("gru", "stitch"), ("attn", "add")])
def test_generate_on_converted_weights_matches_jax(clips, prepared, tmp_path, monkeypatch,
                                                   encoder, blend):
    from diffusestylegesture_torch.cli import zeroeggs as torch_cli
    from diffusestylegesture_torch.sample.engine_zeroeggs import ZeroEggsGenerator
    from diffusestylegesture_tpu.cli import zeroeggs as jax_cli

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import convert_orbax_to_torch

    net = str(tmp_path / "net")
    jax_cli.main(["train", "--data", str(prepared), "--save_dir", net, "--num_steps", "3",
                  "--batch_size", "2", "--window", "8", "--style_encoder", encoder] + SMALL)
    convert_orbax_to_torch.convert(net, str(tmp_path / "converted"))
    stats = str(prepared / "stats.npz")
    styles = ["--style", f"{clips / '001_Happy_0_x_1_0.bvh'}:0:120",
              "--style", str(clips / "002_Sad_0_x_1_0.bvh")]
    common = ["--stats", stats, "--audio", str(clips / "002_Sad_0_x_1_0.wav"), *styles,
              "--blend", blend, "--blend_ratio", "0.4", "0.6", "--seed", "5"]
    jax_cli.main(["generate", "--network", net, "--save_dir", str(tmp_path / "jgen")] + common)

    key = jax.random.PRNGKey(5)  # the JAX CLI's draws: one subkey per style example
    eps = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(sub, (1, 4)))))
    real = ZeroEggsGenerator.encode_style
    pending = iter(eps)
    monkeypatch.setattr(ZeroEggsGenerator, "encode_style",
                        lambda self, ex, generator=None, temperature=1.0, eps=None:
                        real(self, ex, generator, temperature, eps=next(pending)))
    res = torch_cli.main(["generate", "--network", str(tmp_path / "converted"), "--save_dir",
                          str(tmp_path / "tgen"), "--device", "cpu"] + common)
    assert res["frames"] == 240 and res["capture_seconds"] == 0.0
    (jfile,) = os.listdir(tmp_path / "jgen")
    ref, out = _bvh_values(tmp_path / "jgen" / jfile), _bvh_values(res["path"])
    assert ref.shape == out.shape == (240, 75 * 3 + 3)
    # scale: the largest BVH value. The rollout integrates the root rotation
    # frame by frame, and the float32 rounding of XLA and PyTorch parts along
    # it (about 1e-5 degrees at frame 0, 6e-3 at frame 230 of 240 here)
    diff = np.abs((out - ref + 180.0) % 360.0 - 180.0)
    assert diff[0].max() < 1e-4
    assert diff.max() / float(np.abs(ref).max()) < 1e-4
