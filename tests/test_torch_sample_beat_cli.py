"""`diffusestylegesture_torch.cli.sample_beat` end to end on the CPU.

As `tests/test_sample_beat_cli.py` drives the JAX CLI, at the published BEAT v0
widths (njoints 2052, latent 384, fused features 1434, 8 layers) and TWH widths
(2232, 512, 1435) with a 3-step schedule, from the port's own reference-layout
checkpoint (random weights from a seed): the precomputed-features path for
each variant (and `--serve_fast`), and the live path from a wav and its word
timings, with word vectors and a WavLM of width 1024 (one layer), writing
`(real_n, motion_dim)` finite motion. The quality gate refuses a mode its
family's manifest marks degraded before anything loads, passes TWH's gated
dpmpp5 and notes BEAT's unmeasured modes; a yaml asking for MoE raises.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from diffusestylegesture_torch.cli import sample_beat as cli
from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
from diffusestylegesture_torch.models.mdm_plus import MDMPlus
from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig
from diffusestylegesture_torch.sample import quality_gate

from test_torch_isolation import TINY_WAVLM, _wavlm_reference_state_dict

MOTION_DIM = {"BEAT": 684, "TWH": 744}
WIDE_WAVLM = dict(TINY_WAVLM, encoder_embed_dim=1024, encoder_ffn_embed_dim=64,
                  conv_pos_groups=2)


def write_run(tmp_path, dataset="BEAT", name="DiffuseStyleGesture+", diffusion_steps=3,
              checkpoint=True, **extra):
    """A derived-ready yaml, a seeded MDMPlus checkpoint in reference layout,
    stats and a raw seed clip; returns (yaml path, checkpoint path, argv tail)."""
    cfg = dict(dataset=dataset, name=name, version="v0", n_poses=150, n_seed=30,
               latent_dim=384, cond_mask_prob=0.1, audio_feat="wavlm",
               audio_feat_dim_latent=96, noise_schedule="cosine",
               diffusion_steps=diffusion_steps, **extra)
    cfg_path = str(tmp_path / f"{dataset}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    derived = apply_beat_twh_derivations(load_yaml_config(cfg_path))
    torch.manual_seed(3)
    mdm_pt = str(tmp_path / f"{dataset}_{name}.pt")
    if checkpoint:
        torch.save(MDMPlus(cli.mdm_plus_config(derived)).state_dict(), mdm_pt)
    rng = np.random.default_rng(9)
    motion_dim = MOTION_DIM[dataset]
    np.save(tmp_path / "mean.npy", rng.standard_normal(motion_dim).astype(np.float32))
    np.save(tmp_path / "std.npy", (0.5 + rng.random(motion_dim)).astype(np.float32))
    np.save(tmp_path / "seed.npy", rng.standard_normal((40, motion_dim)).astype(np.float32))
    tail = ["--seed_gesture_npy", str(tmp_path / "seed.npy"),
            "--mean_npy", str(tmp_path / "mean.npy"), "--std_npy", str(tmp_path / "std.npy"),
            "--device", "cpu"]
    return cfg_path, mdm_pt, tail


@pytest.mark.parametrize("name,extra", [("DiffuseStyleGesture", []),
                                        ("DiffuseStyleGesture+", []),
                                        ("DiffuseStyleGesture+", ["--serve_fast"]),
                                        ("DiffuseStyleGesture++", [])],
                         ids=["dsg", "dsg+", "dsg+_serve_fast", "dsg++"])
def test_textaudio_npy_path(tmp_path, name, extra):
    cfg_path, mdm_pt, tail = write_run(tmp_path, name=name)
    real_n = 100  # < stride 120: one window, the crop exercised
    np.save(tmp_path / "textaudio.npy",
            np.random.default_rng(1).standard_normal((real_n, 1434)).astype(np.float32))
    save_dir = str(tmp_path / "out")
    res = cli.main(["--config", cfg_path, "--model_path", mdm_pt, "--textaudio_npy",
                    str(tmp_path / "textaudio.npy"), "--speaker", "1", "--save_dir", save_dir]
                   + tail + extra)
    files = [f for f in os.listdir(save_dir) if f.endswith("_motion.npy")]
    assert len(files) == 1 and "spk1" in files[0]
    motion = np.load(os.path.join(save_dir, files[0]))
    assert motion.shape == (real_n, MOTION_DIM["BEAT"]) and np.isfinite(motion).all()
    np.testing.assert_array_equal(motion, res["motion"][0])


def _write_live_inputs(tmp_path, seconds):
    t = np.arange(int(16000 * seconds)) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 2 * t))
           + 0.02 * np.random.default_rng(2).standard_normal(t.shape))
    wav_path = str(tmp_path / "live.wav")
    wavfile.write(wav_path, 16000, (wav * 12000).astype(np.int16))
    tsv = tmp_path / "live.tsv"
    tsv.write_text("0.10\t0.55\thello\n0.60\t1.20\tbig world\n2.0\t2.5\t#laugh#\n")
    vec = tmp_path / "words.vec"
    rng = np.random.default_rng(3)
    with open(vec, "w") as f:
        f.write("3 300\n")
        for w in ("hello", "world", "big"):
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(300)) + "\n")
    wcfg = WavLMConfig(**WIDE_WAVLM)
    cfg_dict = {k: getattr(wcfg, k) for k in WIDE_WAVLM}
    cfg_dict["conv_feature_layers"] = repr([tuple(x) for x in wcfg.conv_feature_layers])
    torch.manual_seed(4)
    wavlm_pt = str(tmp_path / "WavLM-wide.pt")
    torch.save({"cfg": cfg_dict, "model": _wavlm_reference_state_dict(WavLM(wcfg))}, wavlm_pt)
    return ["--wav", wav_path, "--tsv", str(tsv), "--word_vectors", str(vec)], wavlm_pt


@pytest.mark.parametrize("dataset", ["BEAT", "TWH"])
def test_live_wav_tsv_path(tmp_path, dataset):
    cfg_path, mdm_pt, tail = write_run(tmp_path, dataset=dataset)
    live, wavlm_pt = _write_live_inputs(tmp_path, seconds=4.5)
    base = ["--config", cfg_path, "--model_path", mdm_pt, "--speaker", "1"] + live + tail
    with_wavlm = cli.main(base + ["--wavlm_path", wavlm_pt, "--save_dir", str(tmp_path / "a")])
    zeros = cli.main(base + ["--save_dir", str(tmp_path / "b")])
    motion = with_wavlm["motion"]
    # 4.5 s at 30 fps, cropped to the shortest feature: 134-135 frames, two windows
    assert motion.shape[0] == 1 and 130 <= motion.shape[1] <= 136
    assert motion.shape[2] == MOTION_DIM[dataset] and np.isfinite(motion).all()
    assert zeros["motion"].shape == motion.shape
    assert np.abs(zeros["motion"] - motion).max() > 0  # the WavLM features reach the model
    assert with_wavlm["features_seconds"] > 0 and with_wavlm["wavlm_seconds"] > 0


def test_model_dir_holds_the_ports_checkpoint(tmp_path):
    cfg_path, mdm_pt, tail = write_run(tmp_path)
    os.makedirs(tmp_path / "ckpt")
    os.replace(mdm_pt, tmp_path / "ckpt" / "model.pt")
    np.save(tmp_path / "ta.npy", np.zeros((40, 1434), np.float32))
    res = cli.main(["--config", cfg_path, "--model_path", str(tmp_path / "ckpt"),
                    "--textaudio_npy", str(tmp_path / "ta.npy"), "--save_dir",
                    str(tmp_path / "out")] + tail)
    assert res["motion"].shape == (1, 40, 684)
    with pytest.raises(SystemExit, match="model.pt"):
        cli.main(["--config", cfg_path, "--model_path", str(tmp_path), "--textaudio_npy",
                  str(tmp_path / "ta.npy"), "--save_dir", str(tmp_path / "out")] + tail)


def test_quality_gate(tmp_path, monkeypatch, capsys):
    """A mode the BEAT family's manifest marks degraded is refused before any
    model loads; --allow_degraded gets past the gate. With the shipped
    manifest TWH's dpmpp5 passes and BEAT (no family) gets a note."""
    cfg_path, _, tail = write_run(tmp_path, checkpoint=False)
    argv = ["--config", cfg_path, "--model_path", str(tmp_path / "missing.pt"),
            "--textaudio_npy", "x.npy", "--sampler", "dpmpp", "--respace", "2",
            "--save_dir", str(tmp_path / "out")] + tail
    man = {"families": {"beat": {"baseline": "ddpm3", "fgd_ratio_tolerance": 1.1,
                                 "diversity_ratio_min": 0.25,
                                 "modes": {"dpmpp2": {"fgd_ratio": 9.9, "ok": False,
                                                      "diversity_ratio_vs_baseline": 1.0}}}}}
    with monkeypatch.context() as m:
        m.setattr(quality_gate, "MANIFEST_PATH", str(tmp_path / "gate.json"))
        (tmp_path / "gate.json").write_text(json.dumps(man))
        with pytest.raises(SystemExit, match="REFUSED"):
            cli.main(argv)
        with pytest.raises(FileNotFoundError):  # past the gate, at the missing checkpoint
            cli.main(argv + ["--allow_degraded"])
    capsys.readouterr()
    with pytest.raises(FileNotFoundError):
        cli.main(argv)
    assert "no quality manifest for the 'beat' family" in capsys.readouterr().out
    twh_cfg, _, tail = write_run(tmp_path, dataset="TWH", diffusion_steps=1000,
                               checkpoint=False)
    with pytest.raises(FileNotFoundError):
        cli.main(["--config", twh_cfg, "--model_path", str(tmp_path / "missing.pt"),
                  "--textaudio_npy", "x.npy", "--sampler", "dpmpp", "--respace", "5",
                  "--save_dir", str(tmp_path / "out")] + tail)
    assert "quality gate OK for dpmpp5" in capsys.readouterr().out


def test_moe_yaml_and_missing_features_raise(tmp_path):
    # a MoE yaml is served (the expert count comes from the checkpoint, which
    # is missing here)
    cfg_path, _, tail = write_run(tmp_path, checkpoint=False, moe_experts=4)
    with pytest.raises(FileNotFoundError):
        cli.main(["--config", cfg_path, "--model_path", "m.pt", "--textaudio_npy", "x.npy",
                  "--save_dir", str(tmp_path / "out")] + tail)
    with pytest.raises(SystemExit, match="textaudio_npy"):
        cli.main(["--config", cfg_path, "--model_path", "m.pt", "--wav", "a.wav"] + tail)


def test_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", "unused.yml", "--model_path", "m.pt", "--seed_gesture_npy", "s",
                  "--mean_npy", "m", "--std_npy", "s"])
