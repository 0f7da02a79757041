"""BEAT/TWH data preparation, training, serving and BVH export through the
port's CLIs on the CPU.

* `cli/prepare_data.py --dataset TWH|BEAT` against the JAX CLI on one
  synthetic source directory (62-bone TWH BVHs at 30 fps with a metadata csv;
  BEAT BVHs of Hips + 74 target joints + one more at 120 fps; 16 kHz wavs,
  word timings, a `.vec` file and a WavLM checkpoint of width 1024 and one
  layer): per clip the gesture, text and speaker rows exactly the JAX `.h5`'s,
  the 109 host audio columns within 1e-6, the WavLM ones within 1e-4 (WavLM
  runs in each framework) plus the interpolation's position rounding (see
  `test_torch_beat_data.py`), mean and std within 1e-6; the port's
  `--workers 2` store equals its serial one; a speaker slot outside
  `--num_speakers` stops the run, and so does a missing card without
  `--device cpu`.
* prepare → `cli/train.py` (tiny yaml, `--device cpu`) for TWH + / ++ and
  BEAT DiffuseStyleGesture → a resumed run ending at 2N → the checkpoint
  loaded through `load_reference_mdm_plus` gives the in-memory model's
  output → `cli/sample_beat.py --model_path <save_dir>/<step>` → a BVH from
  `twh_features_to_bvh` / `beat_features_to_bvh` with the pipeline fitted on a
  training BVH, parsed back with one frame a served frame; `--device_cache
  --bf16` trains too.
"""
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from diffusestylegesture_tpu.cli import prepare_data as jax_prepare
from diffusestylegesture_torch.cli import prepare_data, sample_beat, train
from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
from diffusestylegesture_torch.data.h5_loader import read_store
from diffusestylegesture_torch.data import load_wav_16k
from diffusestylegesture_torch.models.convert import load_reference_mdm_plus, load_wavlm_checkpoint
from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig, make_twh_wavlm_fn
from diffusestylegesture_torch.motion import pipeline as P
from diffusestylegesture_torch.train import make_beat_cond_builder

from test_torch_isolation import _wavlm_reference_state_dict
from test_torch_sample_beat_cli import WIDE_WAVLM
from torch_port_utils import (interpolation_rounding_bar, synth_beat_full_bvh,
                              synth_twh62_bvh)

CLIPS = {"TWH": ("trn_2023_v0_000_main-agent", "trn_2023_v0_001_main-agent"),
         "BEAT": ("1_wayne_0_1_1", "2_scott_0_2_2")}
META = ("prefix,main-agent_id,main-agent_has_finger,interloctr_id,interloctr_has_finger\n"
        "trn_2023_v0_000,3,finger_incl,4,finger_incl\n"
        "trn_2023_v0_001,9,finger_incl,6,finger_incl\n")
WIDTHS = {"TWH": (744, 302, 17), "BEAT": (684, 301, 2)}
SECONDS = 6.0


def write_source(root, dataset):
    """Seeded clips (BVH, wav, tsv), a metadata csv, a `.vec` file and a
    1024-wide one-layer WavLM in reference layout under `root`."""
    src = root / "raw"
    src.mkdir()
    rng = np.random.default_rng(7)
    for i, name in enumerate(CLIPS[dataset]):
        if dataset == "TWH":
            synth_twh62_bvh(str(src / f"{name}.bvh"), T=int(SECONDS * 30), seed=i)
        else:
            synth_beat_full_bvh(str(src / f"{name}.bvh"), T=int(SECONDS * 120), seed=i)
        t = np.arange(int(16000 * SECONDS)) / 16000
        wav = (0.3 * np.sin(2 * np.pi * (150 + 30 * i) * t) * (1 + np.sin(2 * np.pi * 1.5 * t))
               + 0.02 * rng.standard_normal(t.shape))
        wavfile.write(str(src / f"{name}.wav"), 16000, (wav * 12000).astype(np.int16))
        (src / f"{name}.tsv").write_text("".join(
            f"{s:.2f}\t{s + 0.35:.2f}\t{('hello', 'big world', '#laugh#', 'gone')[k % 4]}\n"
            for k, s in enumerate(np.arange(0.2, SECONDS - 0.5, 0.45))))
    (root / "meta.csv").write_text(META)
    with open(root / "words.vec", "w") as f:
        f.write("3 300\n")
        for w in ("hello", "world", "big"):
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(300)) + "\n")
    wcfg = WavLMConfig(**WIDE_WAVLM)
    cfg = {k: getattr(wcfg, k) for k in WIDE_WAVLM}
    cfg["conv_feature_layers"] = repr([tuple(x) for x in wcfg.conv_feature_layers])
    torch.manual_seed(4)
    torch.save({"cfg": cfg, "model": _wavlm_reference_state_dict(WavLM(wcfg))},
               root / "WavLM.pt")
    return src


def prepare_argv(root, src, dataset, target, jax=False):
    argv = ["--dataset", dataset, "--source", str(src), "--target", str(target),
            "--word_vectors", str(root / "words.vec"), "--wavlm_path", str(root / "WavLM.pt"),
            "--num_speakers", str(WIDTHS[dataset][2])]
    if dataset == "TWH":
        argv += ["--metadata", str(root / "meta.csv")]
    return argv if jax else argv + ["--device", "cpu"]


@pytest.fixture(scope="module")
def prepare(tmp_path_factory):
    """dataset → (root, source dir, the port CLI's result with --workers 2),
    prepared once a module."""
    done = {}

    def get(dataset):
        if dataset not in done:
            root = tmp_path_factory.mktemp(dataset.lower())
            src = write_source(root, dataset)
            out = prepare_data.main(prepare_argv(root, src, dataset, root / f"{dataset}.npz")
                                    + ["--workers", "2"])
            done[dataset] = root, src, out
        return done[dataset]

    return get


@pytest.mark.parametrize("dataset", ["TWH", "BEAT"])
def test_prepare_matches_the_jax_cli(prepare, monkeypatch, dataset):
    monkeypatch.setenv("DSG_TPU_NO_NATIVE", "1")
    root, src, out = prepare(dataset)
    jax_prepare.main(prepare_argv(root, src, dataset, root / "jax.h5", jax=True))
    port, ref = read_store(str(root / f"{dataset}.npz")), read_store(str(root / "jax.h5"))
    motion_dim, text_dim, speakers = WIDTHS[dataset]
    assert sorted(port) == sorted(ref) == ["0", "1"]
    _, wavlm = load_wavlm_checkpoint(str(root / "WavLM.pt"), device="cpu")
    for k, name in zip(("0", "1"), CLIPS[dataset]):
        for f in ("gesture", "text", "speaker_id"):
            np.testing.assert_array_equal(port[k][f], ref[k][f], err_msg=f"{k}/{f}")
        host = np.r_[0:108, 1132]
        np.testing.assert_allclose(port[k]["audio"][:, host], ref[k]["audio"][:, host], rtol=0,
                                   atol=1e-6)
        # WavLM in each framework (the adapter's bar, 1e-4), then interpolated
        # to the clip's frames, the positions of the two packages rounded up to
        # one ulp apart (`test_torch_beat_data.py`)
        with torch.no_grad():
            raw = make_twh_wavlm_fn()(wavlm, torch.as_tensor(load_wav_16k(
                str(src / f"{name}.wav"))))
        bar = 1e-4 + interpolation_rounding_bar(raw.numpy())
        np.testing.assert_allclose(port[k]["audio"], ref[k]["audio"], rtol=0, atol=bar)
        n = len(port[k]["gesture"])
        assert n >= SECONDS * 30 - 3
        assert port[k]["gesture"].shape == (n, motion_dim)
        assert port[k]["audio"].shape == (n, 1133) and port[k]["text"].shape == (n, text_dim)
        assert port[k]["speaker_id"].shape == (speakers,)
    # TWH slots from the metadata (ids 3 and 9, 1-based), BEAT from the names
    slots = [int(port[k]["speaker_id"].argmax()) for k in ("0", "1")]
    assert slots == ([2, 8] if dataset == "TWH" else [0, 1])
    for stat in ("mean", "std"):
        np.testing.assert_allclose(np.load(root / f"{dataset}_{stat}.npy"),
                                   np.load(root / f"jax_{stat}.npy"), rtol=0, atol=1e-6)
    assert set(out["seconds"]) == {"total", "wavlm", "host_wall", "bvh_parse", "gesture",
                                   "audio_text"}


@pytest.mark.parametrize("dataset", ["TWH", "BEAT"])
def test_prepare_workers_equal_serial_and_speaker_slots_are_checked(prepare, tmp_path, dataset):
    root, src, _ = prepare(dataset)
    prepare_data.main(prepare_argv(root, src, dataset, tmp_path / "serial.npz"))
    pool = read_store(str(root / f"{dataset}.npz"))
    serial = read_store(str(tmp_path / "serial.npz"))
    for k in serial:
        for f in serial[k]:
            np.testing.assert_array_equal(pool[k][f], serial[k][f])
    argv = prepare_argv(root, src, dataset, tmp_path / "x.npz")
    argv[argv.index("--num_speakers") + 1] = "1"
    with pytest.raises(SystemExit, match="--num_speakers"):
        prepare_data.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_data.main(argv[:-2])  # --device defaults to the card, absent here


def write_yaml(out_dir, root, dataset, name, save_dir):
    """A tiny training yaml (1 layer, ff 64, batch 4) under `out_dir` for the
    store prepared under `root`."""
    cfg = dict(dataset=dataset, name=name, version="v0", h5file=str(root / f"{dataset}.npz"),
               n_poses=150, n_seed=30, cond_mask_prob=0.1, batch_size=4, num_layers=1,
               ff_size=64, latent_dim=384, audio_feat_dim_latent=96, log_interval=2,
               save_interval=1000, lr=3e-5, weight_decay=0.0, diffusion_steps=1000,
               noise_schedule="cosine", save_dir=str(save_dir))
    path = out_dir / f"{name}.yml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.mark.parametrize("dataset,name", [("TWH", "DiffuseStyleGesture+"),
                                          ("TWH", "DiffuseStyleGesture++"),
                                          ("BEAT", "DiffuseStyleGesture")])
def test_train_resume_serve_and_export(prepare, tmp_path, dataset, name):
    root, src, _ = prepare(dataset)
    save_dir = tmp_path / "ckpt"
    config = write_yaml(tmp_path, root, dataset, name, save_dir)
    with open(config) as f:
        assert yaml.safe_load(f)["h5file"].endswith(".npz")
    first = train.main(["--config", config, "--num_steps", "2", "--device", "cpu"])
    res = train.main(["--config", config, "--num_steps", "4", "--device", "cpu"])
    loop, state = res["loop"], res["state"]
    assert first["state"].step == 2 and loop.resume_step == 2 and state.step == 4
    assert sorted(os.listdir(save_dir)) == ["2", "4"]
    losses = [d["loss"] for d in first["loop"].logged + loop.logged]
    assert len(losses) == 2 and np.isfinite(losses).all()

    # the checkpoint gives the in-memory model's output
    cfg = apply_beat_twh_derivations(load_yaml_config(config))
    served = load_reference_mdm_plus(str(save_dir / "4" / "model.pt"),
                                     sample_beat.mdm_plus_config(cfg), device="cpu")
    batch = next(res["dataset"].batches(2, seed=1))
    x0, cond, _ = make_beat_cond_builder(cfg.cond_mode, cfg.n_seed)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    t = torch.tensor([3, 700])
    with torch.no_grad():
        np.testing.assert_allclose(served(x0, t, cond).numpy(), state.model(x0, t, cond).numpy(),
                                   rtol=0, atol=1e-5)

    # serve the checkpoint from a training clip's features, export the motion
    store = read_store(str(root / f"{dataset}.npz"))
    clip = store["0"]
    real_n = 140
    np.save(tmp_path / "ta.npy", np.concatenate([clip["audio"], clip["text"]], 1)[:real_n])
    np.save(tmp_path / "seed.npy", clip["gesture"][:40])
    out = sample_beat.main([
        "--config", config, "--model_path", str(save_dir / "4"), "--textaudio_npy",
        str(tmp_path / "ta.npy"), "--seed_gesture_npy", str(tmp_path / "seed.npy"),
        "--mean_npy", str(root / f"{dataset}_mean.npy"), "--std_npy",
        str(root / f"{dataset}_std.npy"), "--sampler", "dpmpp", "--respace", "2",
        "--speaker", "1", "--save_dir", str(tmp_path / "served"), "--device", "cpu"])
    motion = out["motion"][0]
    assert motion.shape == (real_n, WIDTHS[dataset][0]) and np.isfinite(motion).all()
    bvh = str(src / f"{CLIPS[dataset][0]}.bvh")
    featurize, export = ((P.twh_features, P.twh_features_to_bvh) if dataset == "TWH" else
                         (P.beat_features, P.beat_features_to_bvh))
    _, pipe = featurize(bvh)
    export(motion, pipe, str(tmp_path / "served.bvh"))
    back = P.parse_bvh(str(tmp_path / "served.bvh"))
    assert back.values.shape[0] == real_n and np.isfinite(back.values).all()
    assert back.columns == P.parse_bvh(bvh).columns


@pytest.mark.parametrize("dataset", ["TWH", "BEAT"])
def test_device_cache_bf16_trains(prepare, tmp_path, dataset):
    root, _, _ = prepare(dataset)
    name = "DiffuseStyleGesture+" if dataset == "TWH" else "DiffuseStyleGesture"
    config = write_yaml(tmp_path, root, dataset, name, tmp_path / "ckpt")
    res = train.main(["--config", config, "--num_steps", "2", "--device", "cpu",
                      "--device_cache", "--bf16"])
    assert res["loop"].device_cache is not None and res["state"].step == 2
    assert np.isfinite([d["loss"] for d in res["loop"].logged]).all()
    assert res["state"].params.data.dtype == res["state"].optimizer.mu.dtype == torch.float32
