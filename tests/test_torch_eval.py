"""Evaluation in the PyTorch port vs the JAX package, on the CPU.

* The numpy metrics (`eval/metrics.py`: FGD, its sqrtm, diversity,
  multimodality, beat alignment; `eval/unconstrained.py`: KID, the
  polynomial MMD and its variance, precision/recall, the manifold estimate
  and the distance matrix) and the onsets (`audio/features.py`) equal the
  JAX package's on the same arrays and wav to 1e-10.
* `cli/eval.py --embedding raw --kid --wav --device cpu` prints what the JAX
  CLI prints for the same clips, key by key, numbers to 1e-6. The JAX CLI
  switches on no compilation cache, so it runs in this process.
* `--embedding autoencoder` trains the autoencoder, caches it under the
  JAX CLI's key as a torch file and reloads it; raw windows above 8192
  dimensions switch to it; `--device cuda` raises without a card.
"""
import json
import os

import numpy as np
import pytest
import torch

from diffusestylegesture_tpu.audio import features as JF
from diffusestylegesture_tpu.cli import eval as jax_eval_cli
from diffusestylegesture_tpu.eval import metrics as JM
from diffusestylegesture_tpu.eval import t2m as JT2M
from diffusestylegesture_tpu.eval import unconstrained as JU
from diffusestylegesture_torch.audio import features as TF
from diffusestylegesture_torch.cli import eval as eval_cli
from diffusestylegesture_torch.eval import metrics as TM
from diffusestylegesture_torch.eval import unconstrained as TU

EXACT = dict(rtol=1e-10, atol=1e-10)


def feats(seed, n=120, d=16, shift=0.0):
    return np.random.default_rng(seed).standard_normal((n, d)) + shift


def test_metrics_match_jax():
    a, b = feats(0), feats(1, n=90, shift=0.3)
    np.testing.assert_allclose(TM.frechet_distance(a, b), JM.frechet_distance(a, b), **EXACT)
    m = a.T @ a / len(a)
    np.testing.assert_allclose(TM.sqrtm(m), JM.sqrtm(m), **EXACT)
    for seed in (0, 3):
        np.testing.assert_allclose(TM.diversity(a, 50, seed), JM.diversity(a, 50, seed), **EXACT)
    per_cond = np.random.default_rng(2).standard_normal((5, 12, 8))
    np.testing.assert_allclose(TM.multimodality(per_cond, 10), JM.multimodality(per_cond, 10),
                               **EXACT)
    motion = np.cumsum(np.random.default_rng(4).standard_normal((200, 9)), axis=0)
    onsets = np.array([0.3, 1.1, 2.05, 4.4, 7.9])
    np.testing.assert_allclose(TM.beat_alignment(motion, onsets, 20.0),
                               JM.beat_alignment(motion, onsets, 20.0), **EXACT)
    assert np.isnan(TM.beat_alignment(motion, np.zeros(0), 20.0))
    with pytest.raises(ValueError, match="too large"):
        TM.frechet_distance(np.zeros((3, 8193)), np.zeros((3, 8193)))


def test_unconstrained_metrics_match_jax():
    g, r = feats(5, n=60), feats(6, n=60, shift=0.2)
    np.testing.assert_allclose(TU.euclidean_distance_matrix(g, r),
                               JT2M.euclidean_distance_matrix(g, r), **EXACT)
    np.testing.assert_allclose(TU.polynomial_mmd(g, r), JU.polynomial_mmd(g, r), **EXACT)
    np.testing.assert_allclose(TU.kid(r, g, n_subsets=20, subset_size=30),
                               JU.kid(r, g, n_subsets=20, subset_size=30), **EXACT)
    np.testing.assert_allclose(TU.kid(r, g, n_subsets=5, subset_size=1000),
                               JU.kid(r, g, n_subsets=5, subset_size=1000), **EXACT)
    np.testing.assert_allclose(TU.precision_and_recall(g, r), JU.precision_and_recall(g, r),
                               **EXACT)
    np.testing.assert_allclose(TU.manifold_estimate(g, r, 5), JU.manifold_estimate(g, r, 5),
                               **EXACT)
    with pytest.raises(ValueError, match="> 3 samples"):
        TU.precision_and_recall(g[:3], r[:3])


def onset_wav(seconds=4.0, sr=16000, seed=0):
    """Clicks on a noise floor: onsets where the clicks are."""
    rng = np.random.default_rng(seed)
    y = 0.01 * rng.standard_normal(int(seconds * sr))
    for t in (0.5, 1.2, 1.9, 2.4, 3.3):
        i = int(t * sr)
        y[i: i + 400] += np.hanning(400) * np.sin(2 * np.pi * 3000 * np.arange(400) / sr)
    return y.astype(np.float32)


def test_onsets_match_jax():
    y = onset_wav()
    np.testing.assert_allclose(TF.hfc_odf(y), JF.hfc_odf(y), **EXACT)
    ours = TF.detect_onsets(y)
    assert len(ours) >= 3
    np.testing.assert_allclose(ours, JF.detect_onsets(y), **EXACT)
    odfs = np.abs(np.random.default_rng(1).standard_normal((2, 300)))
    np.testing.assert_allclose(TF.essentia_onsets(odfs, [1.0, 0.5], 31.25),
                               JF.essentia_onsets(odfs, [1.0, 0.5], 31.25), **EXACT)
    assert len(TF.detect_onsets(np.zeros(0, np.float32))) == 0


@pytest.fixture(scope="module")
def clip_sets(tmp_path_factory):
    """Generated and reference sets of three 200-frame clips of 4 features
    (one generated clip nearly frozen), and a wav per stem."""
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("eval_sets")
    rng = np.random.default_rng(0)
    for name in ("gen", "ref", "wav"):
        (root / name).mkdir()
    for i, stem in enumerate(("a", "b", "c")):
        ref = np.cumsum(rng.standard_normal((200, 4)), axis=0).astype(np.float32)
        gen = ref + 0.5 * rng.standard_normal(ref.shape).astype(np.float32)
        if stem == "c":
            gen = ref[:1] + 0.01 * np.cumsum(rng.standard_normal(ref.shape), axis=0)
        np.save(root / "gen" / f"{stem}.npy", gen.astype(np.float32))
        np.save(root / "ref" / f"{stem}.npy", ref)
        wavfile.write(str(root / "wav" / f"{stem}.wav"), 16000,
                      (onset_wav(10.0, seed=i) * 20000).astype(np.int16))
    return root


def test_cli_eval_raw_matches_the_jax_cli(clip_sets, capsys):
    args = ["--generated", str(clip_sets / "gen"), "--reference", str(clip_sets / "ref"),
            "--wav", str(clip_sets / "wav"), "--window", "10", "--stride", "5", "--kid"]
    ref = jax_eval_cli.main(args)
    ours = eval_cli.main(args + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert ours[k] == v, k
    assert ours["frozen_clip_stems"] == ["c"] and ours["beat_alignment_clips"] == 3


def test_cli_eval_autoencoder_caches_and_reloads(clip_sets, tmp_path, capsys):
    args = ["--generated", str(clip_sets / "gen"), "--reference", str(clip_sets / "ref"),
            "--window", "12", "--stride", "4", "--embedding", "autoencoder", "--ae_steps", "5",
            "--ae_latent", "8", "--ae_cache", str(tmp_path), "--device", "cpu"]
    first = eval_cli.main(args)
    assert os.listdir(tmp_path) == ["ae_params_w12_l8_s5.pt"]
    second = eval_cli.main(args)
    assert first == second and first["embedding"] == "autoencoder"
    assert np.isfinite(first["fgd"]) and first["n_windows_reference"] == 3 * 48


def test_cli_eval_switches_wide_raw_windows_to_the_autoencoder(tmp_path, capsys):
    rng = np.random.default_rng(1)
    for name in ("gen", "ref"):
        (tmp_path / name).mkdir()
        for stem in ("a", "b"):
            np.save(tmp_path / name / f"{stem}.npy",
                    rng.standard_normal((60, 300)).astype(np.float32))
    out = eval_cli.main(["--generated", str(tmp_path / "gen"), "--reference",
                         str(tmp_path / "ref"), "--window", "30", "--stride", "2",
                         "--ae_steps", "2", "--ae_latent", "4", "--device", "cpu"])
    assert out["embedding"] == "autoencoder"
    assert "switching to --embedding autoencoder" in capsys.readouterr().err


def test_cli_eval_refuses_cuda_without_a_card(clip_sets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        eval_cli.main(["--generated", str(clip_sets / "gen"), "--reference",
                       str(clip_sets / "ref")])
