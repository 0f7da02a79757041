"""BEAT/TWH dataset store + in-RAM training loader, host numpy.

Port of `diffusestylegesture_tpu/data/h5_loader.py` (reference
`BEAT-TWH-main/mydiffusion_beat_twh/data_loader/h5_data_loader.py:15-107` and
the builders `process_BEAT_bvh.py:355-441`, `process_TWH_bvh.py:271-355`):

* the store holds, per clip i, `speaker_id` (one-hot), `gesture` (T, motion_dim),
  `audio` (T, 1133) and `text` (T, 301 | 302), cropped to a common length.
  The port writes it as one uncompressed `.npz` whose keys are the JAX
  package's HDF5 paths (`"{i}/gesture"`, `"{i}/audio"`, `"{i}/text"`,
  `"{i}/speaker_id"`): h5py is not on every machine the port runs on. A
  `.h5` store the JAX package wrote is read through h5py, imported only then;
* the loader reads the whole store into RAM, z-normalizes the gesture, derives
  velocity and acceleration over the whole clip (njoints = 3 · motion_dim,
  `:34-35, 58-60`), fuses audio + text per frame, and draws random
  `n_poses`-frame crops (`:71-77`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

FIELDS = ("speaker_id", "gesture", "audio", "text")


def require_h5py():
    """The h5py module, or an ImportError that says what needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing an .h5 file needs h5py, which is not installed; "
                          "the port's dataset store is an .npz (prepare it with an .npz "
                          "--target)") from e
    return h5py


def _kind(path: str) -> str:
    if path.endswith(".npz"):
        return "npz"
    if path.endswith((".h5", ".hdf5")):
        return "h5"
    raise ValueError(f"{path}: a dataset store is an .npz (the port's) or an .h5 (h5py)")


def build_h5_dataset(path: str, clips: List[Dict[str, np.ndarray]]) -> None:
    """Write clips [{'speaker_id', 'gesture', 'audio', 'text'}] → the port's
    `.npz` store, each clip's modalities cropped to their common length."""
    if _kind(path) != "npz":
        raise ValueError(f"{path}: the port writes its dataset store as an .npz")
    arrays = {}
    for i, c in enumerate(clips):
        n = min(len(c["gesture"]), len(c["audio"]), len(c["text"]))
        arrays.update({f"{i}/speaker_id": c["speaker_id"], f"{i}/gesture": c["gesture"][:n],
                       f"{i}/audio": c["audio"][:n], f"{i}/text": c["text"][:n]})
    np.savez(path, **arrays)


def read_store(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{clip key: {field: array}} of a store written by `build_h5_dataset`
    (the port's `.npz`) or by the JAX package (`.h5`, needs h5py)."""
    if _kind(path) == "npz":
        out: Dict[str, Dict[str, np.ndarray]] = {}
        with np.load(path, allow_pickle=False) as z:
            for name in z.files:
                k, f = name.split("/")
                out.setdefault(k, {})[f] = z[name]
        return out
    with require_h5py().File(path, "r") as h5:
        return {k: {f: h5[k][f][()] for f in FIELDS} for k in h5.keys()}


def gesture_statistics(h5_path: str, eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """Global mean / (std + eps) over all gesture frames, the clips in HDF5's
    name order as in the JAX package (parity: `calculate_gesture_statistics.py:7-16`)."""
    store = read_store(h5_path)
    stacked = np.concatenate([store[k]["gesture"] for k in sorted(store)], axis=0)
    return stacked.mean(axis=0), stacked.std(axis=0) + eps


class SpeechGestureDataset:
    """The clips of a store, normalized, each with [pos | vel | acc] gesture
    channels and fused [audio | text] features, float32, in clip order."""

    def __init__(self, h5_path: str, mean: np.ndarray, std: np.ndarray, n_poses: int = 150):
        self.n_poses = n_poses
        self.textaudio: List[np.ndarray] = []
        self.gesture: List[np.ndarray] = []
        self.speaker: List[np.ndarray] = []
        store = read_store(h5_path)
        for k in sorted(store, key=int):
            clip = store[k]
            g = (clip["gesture"] - mean) / std
            # velocity and acceleration over the WHOLE clip (zero first row), the
            # crop afterwards (`h5_data_loader.py:34-35`, crop at `:58-60`): a
            # window's frame 0 keeps the true derivative across its boundary
            vel = np.diff(g, axis=0, prepend=g[:1])
            acc = np.diff(vel, axis=0, prepend=vel[:1])
            self.gesture.append(np.concatenate([g, vel, acc], axis=1).astype(np.float32))
            self.textaudio.append(
                np.concatenate([clip["audio"], clip["text"]], axis=1).astype(np.float32))
            self.speaker.append(np.asarray(clip["speaker_id"], np.float32))

    def __len__(self) -> int:
        return len(self.gesture)

    def sample(self, rng: np.random.Generator, idx: int):
        """(textaudio, gesture, speaker) of one `n_poses`-frame crop of clip `idx`."""
        T = len(self.gesture[idx])
        n = self.n_poses
        # the reference's np.random.randint has an EXCLUSIVE high
        # (`h5_data_loader.py:44`): the start T - n is never drawn
        start = int(rng.integers(0, max(1, T - n)))
        g = self.gesture[idx][start: start + n]
        a = self.textaudio[idx][start: start + n]
        if len(g) < n:  # a short clip is padded by repeating it
            reps = -(-n // len(g))
            g = np.tile(g, (reps, 1))[:n]
            a = np.tile(a, (reps, 1))[:n]
        return a, g, self.speaker[idx]

    def batches(self, batch_size: int, seed: int = 0,
                num_batches: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Random batches {'audio', 'motion', 'style'} for ever (or
        `num_batches`), on numpy's `default_rng(seed)` as in the JAX package
        (ref `RandomSampler:71-77`)."""
        rng = np.random.default_rng(seed)
        produced = 0
        while num_batches is None or produced < num_batches:
            idx = rng.integers(0, len(self), batch_size)
            items = [self.sample(rng, int(i)) for i in idx]
            yield {"audio": np.stack([i[0] for i in items]),
                   "motion": np.stack([i[1] for i in items]),
                   "style": np.stack([i[2] for i in items])}
            produced += 1
