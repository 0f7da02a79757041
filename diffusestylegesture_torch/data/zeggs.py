"""ZEGGS dataset building and the training windows.

Port of `diffusestylegesture_tpu/data/zeggs.py` (reference
`main/mydiffusion_zeggs/zeggs_data_to_lmdb.py:24-176`,
`data_loader/data_preprocessor.py:38-153`, `lmdb_data_loader.py:13-67`),
npz shards in place of the reference's LMDB:

* `build_zeggs_dataset`: per clip the 16 kHz wav (EBU R128 normalized with
  `loudnorm=True`, in place of the reference's external `ffmpeg-normalize`),
  its Sphinx MFCC and the 1141-d BVH features; the global mean/std (std
  clipped at 0.01 when normalizing); the first clip(s) as the valid split;
  the style one-hot from the file name's second token.
* `ZeggsWindowDataset`: 88-frame windows at stride 10 with their raw-audio
  slices, WavLM features computed once in batches of 16 and cached beside
  the shards; `batches()` shuffles with numpy's `default_rng(seed)`, so the
  batch order is the JAX package's.
"""
from __future__ import annotations

import glob
import hashlib
import math
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ..audio import sphinx_mfcc_energy
from ..motion import zeggs_features as zf


def load_wav_16k(path: str) -> np.ndarray:
    """Read a wav file as float32 mono 16 kHz (scipy backend)."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != 16000:
        g = math.gcd(int(sr), 16000)
        data = resample_poly(data, 16000 // g, sr // g).astype(np.float32)
    return data


def _zeggs_clip_worker(task) -> dict:
    """One clip's featurization (module level, so a spawned worker can run it)."""
    wav_path, bvh_path, name, style, fps, loudnorm = task
    audio = load_wav_16k(wav_path)
    if loudnorm:
        from ..audio.loudness import normalize_loudness

        audio = normalize_loudness(audio, 16000.0)
    mfcc = sphinx_mfcc_energy(audio, frate=fps)[:, :-2]
    feats = zf.featurize_bvh_file(bvh_path, fps=fps)["features"]
    return dict(name=name, audio=audio, mfcc=mfcc, poses=feats, style=style)


def build_zeggs_dataset(source_dir: str, target_dir: str, fps: int = 20,
                        valid_fraction: float = 0.1, workers: int = 0,
                        loudnorm: bool = False) -> Dict[str, np.ndarray]:
    """(source_dir/*.wav + *.bvh) → target_dir/{train,valid}/<name>.npz
    ({poses (normalized), audio_raw, mfcc, style}) + mean.npz / std.npz.

    `workers` > 1 featurizes the clips in a pool of spawned processes; the
    clip order, and so mean/std and the split, is the serial build's.
    """
    os.makedirs(target_dir, exist_ok=True)
    tasks = []
    for wav_path in sorted(glob.glob(os.path.join(source_dir, "*.wav"))):
        name = os.path.splitext(os.path.basename(wav_path))[0]
        tokens = name.split("_")
        style = zf.style_onehot(tokens[1]) if len(tokens) > 1 else None
        bvh_path = os.path.join(source_dir, name + ".bvh")
        if style is None or not os.path.exists(bvh_path):
            continue
        tasks.append((wav_path, bvh_path, name, style, fps, loudnorm))
    if not tasks:
        raise ValueError(f"no usable (wav, bvh) pairs in {source_dir}")

    if workers and workers > 1 and len(tasks) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn")) as ex:
            clips = list(ex.map(_zeggs_clip_worker, tasks))
    else:
        clips = [_zeggs_clip_worker(t) for t in tasks]

    stacked = np.concatenate([c["poses"] for c in clips], axis=0)
    mean = stacked.mean(axis=0)
    std = stacked.std(axis=0)
    np.savez(os.path.join(target_dir, "mean.npz"), mean=mean)
    np.savez(os.path.join(target_dir, "std.npz"), std=std)
    std_c = np.clip(std, 0.01, None)

    n_valid = max(1, int(len(clips) * valid_fraction)) if len(clips) > 1 else 0
    for split, items in (("valid", clips[:n_valid]), ("train", clips[n_valid:])):
        out = os.path.join(target_dir, split)
        os.makedirs(out, exist_ok=True)
        for c in items:
            np.savez_compressed(os.path.join(out, c["name"] + ".npz"),
                                poses=((c["poses"] - mean) / std_c).astype(np.float32),
                                audio_raw=c["audio"], mfcc=c["mfcc"].astype(np.float32),
                                style=c["style"])
    return {"mean": mean, "std": std}


def _shard_paths(shard_dir: str):
    return sorted(p for p in glob.glob(os.path.join(shard_dir, "*.npz"))
                  if not os.path.basename(p).startswith("_cache"))


class ZeggsWindowDataset:
    """Windows of built ZEGGS shards with their WavLM features.

    `wavlm_fn(windows (B, S) float32) → (B, n_poses, 1024)` computes the
    features, 16 windows a call, once; they are cached beside the shards in
    a file named after the shard set's fingerprint, so rebuilt shards make a
    new cache. Without a `wavlm_fn` the cached features are used; with
    neither, construction raises: the model is never trained without audio
    features.
    """

    def __init__(self, shard_dir: str,
                 wavlm_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 n_poses: int = 88, stride: int = 10, fps: int = 20, sr: int = 16000,
                 cache_path: Optional[str] = None):
        self.n_poses, self.stride, self.fps, self.sr = n_poses, stride, fps, sr
        self.audio_len = int(n_poses / fps * sr)
        shards = _shard_paths(shard_dir)
        if cache_path is None:
            sig = hashlib.sha1(repr([(os.path.basename(p), os.path.getmtime(p),
                                      os.path.getsize(p)) for p in shards]).encode()).hexdigest()[:10]
            cache_path = os.path.join(shard_dir, f"_cache_{n_poses}_{stride}_{sig}.npz")

        if os.path.exists(cache_path):
            with np.load(cache_path) as blob:
                # a cache without features cannot serve a caller that gives a
                # wavlm_fn: rebuild it instead
                if not (wavlm_fn is not None and "wavlm" not in blob):
                    self.poses, self.styles = blob["poses"], blob["styles"]
                    self.audio = blob["audio"] if "audio" in blob else None
                    self.wavlm = blob["wavlm"] if "wavlm" in blob else None
                    self._require_features(cache_path)
                    return

        poses_w, styles_w, audio_w = [], [], []
        for shard in shards:
            with np.load(shard) as blob:
                poses, audio, style = blob["poses"], blob["audio_raw"], blob["style"]
                mfcc_len = (len(blob["mfcc"]) if "mfcc" in blob
                            else int(len(audio) * fps / sr + 1))
            # reference MINLEN (`data_preprocessor.py:94`): its 60/sr audio term
            # assumes 60 fps; the mfcc term, at the pose rate, is the real cap
            minlen = min(len(poses), int(len(audio) * 60 / sr), mfcc_len)
            for i in range(max(0, math.floor((minlen - n_poses) / stride))):
                s = i * stride
                poses_w.append(poses[s: s + n_poses])
                a0 = math.floor(s / len(poses) * len(audio))
                seg = audio[a0: a0 + self.audio_len]
                if len(seg) < self.audio_len:
                    seg = np.pad(seg, (0, self.audio_len - len(seg)))
                audio_w.append(seg)
                styles_w.append(style)

        self.poses = (np.stack(poses_w).astype(np.float32) if poses_w
                      else np.zeros((0, n_poses, zf.ZEGGS_FEATURE_DIM), np.float32))
        self.styles = (np.stack(styles_w).astype(np.float32) if styles_w
                       else np.zeros((0, len(zf.STYLE_NAMES)), np.float32))
        self.audio = np.stack(audio_w).astype(np.float32) if audio_w else None
        self.wavlm = None
        if wavlm_fn is not None and self.audio is not None:
            self.wavlm = np.concatenate(
                [np.asarray(wavlm_fn(self.audio[i: i + 16]), np.float32)
                 for i in range(0, len(self.audio), 16)], axis=0)
        self._require_features(shard_dir)

        save = dict(poses=self.poses, styles=self.styles)
        if self.audio is not None:
            save["audio"] = self.audio
        save["wavlm"] = self.wavlm
        np.savez(cache_path, **save)

    def _require_features(self, where: str) -> None:
        if self.wavlm is None:
            raise ValueError(
                f"no WavLM features for the windows of {where}: pass a wavlm_fn (a WavLM "
                "checkpoint) or build the feature cache first; training needs audio features")

    def __len__(self) -> int:
        return len(self.poses)

    def batches(self, batch_size: int, seed: int = 0,
                epochs: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled batches {motion, style, wavlm}; epochs=None → endless."""
        if not 0 < batch_size <= len(self):
            raise ValueError(f"batch_size {batch_size} for {len(self)} windows")
        rng = np.random.default_rng(seed)
        ep = 0
        while epochs is None or ep < epochs:
            order = rng.permutation(len(self))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[i: i + batch_size]
                yield {"motion": self.poses[idx], "style": self.styles[idx],
                       "wavlm": self.wavlm[idx]}
            ep += 1
