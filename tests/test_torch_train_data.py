"""The ZEGGS data path of the PyTorch port vs the JAX package: Sphinx MFCC
(1e-8, both float64 numpy), BVH import (equal), 1141-d featurization (1e-4
rtol and atol: the JAX path computes in float32 through XLA, the port in
float32 numpy), the built shards and mean/std (1e-4), the windows and the
batch order for a seed (equal, read from the same shards), the
prepare-data CLI and the on-device window cache.
"""
import os

import numpy as np
import pytest
import torch

from diffusestylegesture_tpu.audio import sphinx_mfcc as jax_mfcc
from diffusestylegesture_tpu.data import zeggs as jax_zeggs
from diffusestylegesture_tpu.motion import bvh as jax_bvh
from diffusestylegesture_tpu.motion import zeggs_features as jax_zf
from diffusestylegesture_torch.audio import sphinx_mfcc_energy
from diffusestylegesture_torch.cli import prepare_data
from diffusestylegesture_torch.data import ZeggsWindowDataset, build_zeggs_dataset
from diffusestylegesture_torch.data.device_cache import DeviceWindowCache
from diffusestylegesture_torch.motion import bvh, zeggs_features as zf

FEAT_TOL = dict(rtol=1e-4, atol=1e-4)


def write_clip(dirpath, name, seconds=6.0, fps=60, seed=0, sr=16000):
    """A paired ZEGGS-style clip: a wav, and a BVH of the 75-joint skeleton
    with smooth seeded rotations, written by the port's `bvh.save`."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * (150 + 50 * seed) * t) + 0.02 * rng.standard_normal(t.shape)
    wavfile.write(os.path.join(dirpath, name + ".wav"), sr, (wav * 32767).astype(np.int16))
    T, J = int(seconds * fps), zf.ZEGGS_NJOINTS
    phase = rng.uniform(0, 2 * np.pi, (1, J, 3))
    freq = rng.uniform(0.2, 1.5, (1, J, 3))
    amp = rng.uniform(5, 30, (1, J, 3))
    rot = amp * np.sin(2 * np.pi * freq * (np.arange(T)[:, None, None] / fps) + phase)
    offsets = rng.uniform(-10, 10, (J, 3)).astype(np.float32)
    pos = np.broadcast_to(offsets, (T, J, 3)).copy()
    pos[:, 0] = [0.0, 100.0, 0.0] + np.cumsum(rng.normal(0, 0.2, (T, 3)), axis=0) * [1, 0, 1]
    bvh.save(os.path.join(dirpath, name + ".bvh"),
             dict(rotations=rot.astype(np.float32), positions=pos.astype(np.float32),
                  offsets=offsets, parents=zf.ZEGGS_PARENTS, names=list(zf.ZEGGS_BONE_NAMES),
                  order="zyx", frametime=1.0 / fps))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    src = tmp_path_factory.mktemp("zeggs_src")
    for i, name in enumerate(("001_Happy_0_x_1_0", "002_Sad_0_x_1_0", "003_Old_1_x_1_0")):
        write_clip(str(src), name, seconds=6.0 + i, seed=i)
    with open(src / "004_Unknown_0.wav", "wb"):  # no style token, no BVH: skipped
        pass
    return src


@pytest.mark.parametrize("seconds", [1.0, 2.3712])
def test_sphinx_mfcc_matches_jax(seconds):
    rng = np.random.default_rng(0)
    n = int(16000 * seconds)
    sig = (0.2 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000)
           + 0.05 * rng.standard_normal(n)).astype(np.float32)
    for frate in (100, 20):
        np.testing.assert_allclose(sphinx_mfcc_energy(sig, frate=frate),
                                   jax_mfcc.sphinx_mfcc_energy(sig, frate=frate),
                                   rtol=1e-8, atol=1e-8)


def test_bvh_load_matches_jax(clips):
    path = str(clips / "001_Happy_0_x_1_0.bvh")
    mine, ref = bvh.load(path), jax_bvh.load(path)
    assert set(mine) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
        else:
            assert mine[k] == ref[k], k


def test_featurize_bvh_file_matches_jax(clips):
    path = str(clips / "002_Sad_0_x_1_0.bvh")
    mine, ref = zf.featurize_bvh_file(path), jax_zf.featurize_bvh_file(path)
    assert mine["features"].shape == (140, zf.ZEGGS_FEATURE_DIM)
    assert mine["features"].dtype == np.float32
    np.testing.assert_allclose(mine["features"], ref["features"], **FEAT_TOL)
    assert mine["dt"] == ref["dt"] and mine["njoints"] == ref["njoints"]


def test_featurize_rejects_a_non_divisor_fps(clips):
    with pytest.raises(ValueError, match="integer-divide"):
        zf.featurize_bvh_file(str(clips / "001_Happy_0_x_1_0.bvh"), fps=25)


@pytest.fixture(scope="module")
def built(clips, tmp_path_factory):
    """The shards of both packages from the same clips."""
    out = tmp_path_factory.mktemp("built")
    stats_t = build_zeggs_dataset(str(clips), str(out / "torch"), fps=20)
    stats_j = jax_zeggs.build_zeggs_dataset(str(clips), str(out / "jax"), fps=20)
    return out, stats_t, stats_j


def test_build_zeggs_dataset_matches_jax(built):
    out, stats_t, stats_j = built
    for k in ("mean", "std"):
        np.testing.assert_allclose(stats_t[k], stats_j[k], **FEAT_TOL)
        np.testing.assert_array_equal(np.load(out / "torch" / f"{k}.npz")[k], stats_t[k])
    for split, names in (("valid", ["001_Happy_0_x_1_0"]),
                         ("train", ["002_Sad_0_x_1_0", "003_Old_1_x_1_0"])):
        assert sorted(os.listdir(out / "torch" / split)) == [n + ".npz" for n in names]
        for n in names:
            a, b = np.load(out / "torch" / split / f"{n}.npz"), np.load(out / "jax" / split / f"{n}.npz")
            assert set(a.files) == set(b.files) == {"poses", "audio_raw", "mfcc", "style"}
            np.testing.assert_array_equal(a["audio_raw"], b["audio_raw"])
            np.testing.assert_array_equal(a["style"], b["style"])
            np.testing.assert_allclose(a["mfcc"], b["mfcc"], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(a["poses"], b["poses"], **FEAT_TOL)


def test_workers_build_the_same_dataset(clips, built, tmp_path):
    out, stats_t, _ = built
    stats = build_zeggs_dataset(str(clips), str(tmp_path / "pool"), fps=20, workers=2)
    np.testing.assert_array_equal(stats["mean"], stats_t["mean"])
    for n in ("002_Sad_0_x_1_0", "003_Old_1_x_1_0"):
        a = np.load(tmp_path / "pool" / "train" / f"{n}.npz")
        b = np.load(out / "torch" / "train" / f"{n}.npz")
        np.testing.assert_array_equal(a["poses"], b["poses"])


def fake_wavlm(windows):
    """A deterministic stand-in for WavLM: (B, S) → (B, 88, 1024)."""
    w = np.asarray(windows, np.float32)
    frames = w[:, : 88 * 800].reshape(len(w), 88, 800).mean(-1, keepdims=True)
    return np.tile(frames, (1, 1, 1024)) * np.linspace(0.5, 1.5, 1024, dtype=np.float32)


def test_window_dataset_matches_jax(built, tmp_path):
    out, _, _ = built
    shards = str(out / "jax" / "train")
    mine = ZeggsWindowDataset(shards, fake_wavlm, cache_path=str(tmp_path / "mine.npz"))
    ref = jax_zeggs.ZeggsWindowDataset(shards, fake_wavlm, cache_path=str(tmp_path / "ref.npz"))
    # 7 s and 8 s clips at 20 fps: ⌊(140 − 88) / 10⌋ + ⌊(160 − 88) / 10⌋ windows
    assert len(mine) == len(ref) == 5 + 7
    for k in ("poses", "styles", "audio", "wavlm"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(ref, k), err_msg=k)
    for seed in (0, 3):
        got = mine.batches(4, seed=seed, epochs=2)
        want = ref.batches(4, seed=seed, epochs=2)
        n = 0
        for a, b in zip(got, want):
            assert set(a) == {"motion", "style", "wavlm"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            n += 1
        assert n == 2 * (12 // 4)
    # the cache serves a later construction without a WavLM
    again = ZeggsWindowDataset(shards, cache_path=str(tmp_path / "mine.npz"))
    np.testing.assert_array_equal(again.wavlm, mine.wavlm)


def test_window_dataset_needs_audio_features(built, tmp_path):
    out, _, _ = built
    with pytest.raises(ValueError, match="audio features"):
        ZeggsWindowDataset(str(out / "torch" / "train"), None, cache_path=str(tmp_path / "c.npz"))
    ds = ZeggsWindowDataset(str(out / "torch" / "train"), fake_wavlm,
                            cache_path=str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="batch_size"):
        next(ds.batches(len(ds) + 1))


def test_default_cache_is_fingerprinted(built, tmp_path):
    import shutil

    shards = tmp_path / "train"
    shutil.copytree(built[0] / "torch" / "train", shards)
    ZeggsWindowDataset(str(shards), fake_wavlm)
    caches = [p for p in os.listdir(shards) if p.startswith("_cache_88_10_")]
    assert len(caches) == 1
    ds = ZeggsWindowDataset(str(shards))  # from the cache, without WavLM
    assert ds.wavlm is not None and len(ds) == 12


def test_a_cache_being_written_is_not_read_as_a_shard(built, tmp_path, monkeypatch):
    """The ranks of a meshed run build the cache at once: one rank's file in
    the making must not enter another rank's list of shards."""
    import shutil

    from diffusestylegesture_torch.data import zeggs

    shards = tmp_path / "train"
    shutil.copytree(built[0] / "torch" / "train", shards)
    savez, seen = np.savez, []

    def savez_while_another_rank_reads(f, **arrays):
        savez(f, **arrays)
        if not seen:  # the file is there, not yet renamed into place
            seen.append(sorted(os.listdir(shards)))
            other = ZeggsWindowDataset(str(shards), fake_wavlm,
                                       cache_path=str(tmp_path / "other.npz"))
            seen.append(len(other))

    monkeypatch.setattr(zeggs.np, "savez", savez_while_another_rank_reads)
    ds = ZeggsWindowDataset(str(shards), fake_wavlm)
    assert any(n.startswith("_cache_partial_") for n in seen[0])
    assert seen[1] == len(ds) == 12


def test_prepare_data_cli(clips, tmp_path):
    stats = prepare_data.main(["--dataset", "ZEGGS", "--source", str(clips), "--target",
                               str(tmp_path / "out"), "--normalize_loudness"])
    assert stats["mean"].shape == (zf.ZEGGS_FEATURE_DIM,)
    assert sorted(os.listdir(tmp_path / "out" / "train")) == ["002_Sad_0_x_1_0.npz",
                                                              "003_Old_1_x_1_0.npz"]
    for ds in ("BEAT", "TWH"):  # ZEGGS clips have no word timings: no BEAT/TWH triple
        with pytest.raises(SystemExit, match="no usable"):
            prepare_data.main(["--dataset", ds, "--source", str(clips), "--target",
                               str(tmp_path / f"{ds}.npz"), "--device", "cpu"])


def test_device_cache_gathers_rows(built, tmp_path):
    ds = ZeggsWindowDataset(str(built[0] / "torch" / "train"), fake_wavlm,
                            cache_path=str(tmp_path / "c.npz"))
    cache = DeviceWindowCache.from_zeggs(ds, device="cpu")
    assert cache.n == len(ds) and set(cache.arrays) == {"motion", "style", "wavlm"}
    batch = cache.sample_batch(cache.arrays, torch.Generator().manual_seed(3), 5)
    idx = torch.randint(0, len(ds), (5,), generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(batch["motion"].numpy(), ds.poses[idx])
    np.testing.assert_array_equal(batch["wavlm"].numpy(), ds.wavlm[idx])
    with pytest.raises(ValueError, match="rows"):
        DeviceWindowCache({"a": np.zeros((3, 2)), "b": np.zeros((4, 2))}, device="cpu")
