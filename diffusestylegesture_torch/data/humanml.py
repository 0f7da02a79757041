"""HumanML3D / KIT text-to-motion data loading (MDM-legacy surface).

Port of `diffusestylegesture_tpu/data/humanml.py` (numpy, kept as the port's
own copy), the used subset of the reference's humanml loaders:

  * `WordVectorizer` (`main/data_loaders/humanml/utils/word_vectorizer.py`):
    GloVe table + POS one-hot with the VIP word-class overrides, from the same
    artifacts (`{prefix}_data.npy`, `{prefix}_words.pkl`, `{prefix}_idx.pkl`);
  * `lengths_to_mask` / `collate_tensors` / `collate` / `t2m_collate`
    (`main/data_loaders/tensors.py`) in numpy;
  * `Text2MotionDataset`, `Text2MotionDatasetV2` semantics
    (`main/data_loaders/humanml/data/dataset.py:207-345`), with an explicit
    `numpy.random.Generator` drawn in the JAX package's order, so that the
    batches for a seed equal its batches.

`batches()` / `train_batches()` yield numpy batches; `cli/train_t2m.py`
copies them to the device.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Sequence

import numpy as np

POS_enumerator = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5,
    "PRON": 6, "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10,
    "Obj_VIP": 11, "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

Loc_list = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
            "forward", "back", "backward", "up", "down", "straight", "curve")
Body_list = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
             "waist", "eye", "knee", "shoulder", "thigh")
Obj_List = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
            "handrail", "baseball", "basketball")
Act_list = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
            "throw", "hop", "dance", "jump", "turn", "stumble", "dance",
            "stop", "sit", "lift", "lower", "raise", "wash", "stand", "kneel",
            "stroll", "rub", "bend", "balance", "flap", "jog", "shuffle",
            "lean", "rotate", "spin", "spread", "climb")
Desc_list = ("slowly", "carefully", "fast", "careful", "slow", "quickly",
             "happy", "angry", "sad", "happily", "angrily", "sadly")

VIP_dict = {
    "Loc_VIP": Loc_list,
    "Body_VIP": Body_list,
    "Obj_VIP": Obj_List,
    "Act_VIP": Act_list,
    "Desc_VIP": Desc_list,
}


class WordVectorizer:
    """word/POS token ('walk/VERB') -> (GloVe vector, POS one-hot)."""

    def __init__(self, meta_root: str, prefix: str):
        vectors = np.load(os.path.join(meta_root, f"{prefix}_data.npy"))
        with open(os.path.join(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(os.path.join(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            word2idx = pickle.load(f)
        self.word2vec = {w: vectors[word2idx[w]] for w in words}

    @staticmethod
    def _pos_onehot(pos: str) -> np.ndarray:
        vec = np.zeros(len(POS_enumerator))
        vec[POS_enumerator.get(pos, POS_enumerator["OTHER"])] = 1
        return vec

    def __len__(self) -> int:
        return len(self.word2vec)

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            vip_pos = next(
                (key for key, values in VIP_dict.items() if word in values), None)
            pos_vec = self._pos_onehot(vip_pos if vip_pos is not None else pos)
        else:
            word_vec = self.word2vec["unk"]
            pos_vec = self._pos_onehot("OTHER")
        return word_vec, pos_vec


# --- collate (tensors.py) -----------------------------------------------------


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]


def collate_tensors(batch: Sequence[np.ndarray]) -> np.ndarray:
    dims = batch[0].ndim
    max_size = [max(b.shape[i] for b in batch) for i in range(dims)]
    canvas = np.zeros((len(batch), *max_size), dtype=batch[0].dtype)
    for i, b in enumerate(batch):
        canvas[(i,) + tuple(slice(0, s) for s in b.shape)] = b
    return canvas


def collate(batch: Sequence[dict]):
    """List of sample dicts -> (motion (B, J, F, T), cond {'y': ...}) —
    the conditioning layout of `tensors.py:24-58`."""
    items = [b for b in batch if b is not None]
    data = collate_tensors([np.asarray(b["inp"], dtype=np.float32) for b in items])
    if "lengths" in items[0]:
        lengths = np.asarray([b["lengths"] for b in items])
    else:
        lengths = np.asarray([b["inp"].shape[-1] for b in items])
    mask = lengths_to_mask(lengths, data.shape[-1])[:, None, None, :]
    cond = {"y": {"mask": mask, "lengths": lengths}}
    for key in ("text", "tokens", "action_text"):
        if key in items[0]:
            cond["y"][key] = [b[key] for b in items]
    if "action" in items[0]:
        cond["y"]["action"] = np.asarray([b["action"] for b in items])[:, None]
    return data, cond


def t2m_collate(batch: Sequence[tuple]):
    """Adapter from Text2MotionDataset sample tuples (tensors.py:61-70):
    motion (T, J) -> inp (J, 1, T)."""
    adapted = [
        {
            "inp": np.asarray(b[4], dtype=np.float32).T[:, None, :],
            "text": b[2],
            "tokens": b[6],
            "lengths": b[5],
        }
        for b in batch
    ]
    return collate(adapted)


# --- dataset ------------------------------------------------------------------


@dataclass
class T2MConfig:
    motion_dir: str
    text_dir: str
    dataset_name: str = "t2m"  # 't2m' (humanml) or 'kit'
    max_motion_length: int = 196
    max_text_len: int = 20
    unit_length: int = 4
    fps: int = 20
    max_ids: int | None = None  # reference debug-caps at 100 (dataset.py:221)


@dataclass
class _Clip:
    motion: np.ndarray
    length: int
    text: List[dict] = field(default_factory=list)


class Text2MotionDataset:
    """Text2MotionDatasetV2 with explicit RNG (dataset.py:207-345)."""

    def __init__(self, cfg: T2MConfig, mean: np.ndarray, std: np.ndarray,
                 split_file: str, w_vectorizer: WordVectorizer | None,
                 seed: int = 0):
        # w_vectorizer may be None for training (`cli.train_t2m`): GloVe
        # word/POS vectors feed only the T2M evaluator (`__getitem__` /
        # `batches`); the denoiser conditions on CLIP caption embeddings
        # (`train_batches`).
        self.cfg = cfg
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)
        self.w_vectorizer = w_vectorizer
        self.rng = np.random.default_rng(seed)
        self.max_length = 20
        self.pointer = 0
        min_len = 40 if cfg.dataset_name == "t2m" else 24

        with open(split_file) as f:
            id_list = [ln.strip() for ln in f if ln.strip()]
        if cfg.max_ids is not None:
            id_list = id_list[: cfg.max_ids]

        data: Dict[str, _Clip] = {}
        names, lengths = [], []
        for name in id_list:
            path = os.path.join(cfg.motion_dir, name + ".npy")
            if not os.path.exists(path):
                continue
            motion = np.load(path)
            if len(motion) < min_len or len(motion) >= 200:
                continue
            whole_clip_texts = []
            with open(os.path.join(cfg.text_dir, name + ".txt")) as f:
                for line in f:
                    parts = line.strip().split("#")
                    if len(parts) < 4:
                        continue
                    caption, tokens = parts[0], parts[1].split(" ")
                    # per-line tolerance (the reference wraps each clip in
                    # a bare try/except, `dataset.py` — real HumanML3D
                    # releases contain lines whose caption itself holds
                    # '#', shifting the fields): skip the line, keep the
                    # corpus
                    try:
                        f_tag = (0.0 if parts[2] in ("", "nan")
                                 else float(parts[2]))
                        to_tag = (0.0 if parts[3] in ("", "nan")
                                  else float(parts[3]))
                    except ValueError:
                        continue
                    f_tag = 0.0 if np.isnan(f_tag) else f_tag
                    to_tag = 0.0 if np.isnan(to_tag) else to_tag
                    entry = {"caption": caption, "tokens": tokens}
                    if f_tag == 0.0 and to_tag == 0.0:
                        whole_clip_texts.append(entry)
                    else:
                        sub = motion[int(f_tag * cfg.fps): int(to_tag * cfg.fps)]
                        if len(sub) < min_len or len(sub) >= 200:
                            continue
                        new_name = f"{len(names)}_{name}"
                        data[new_name] = _Clip(sub, len(sub), [entry])
                        names.append(new_name)
                        lengths.append(len(sub))
            if whole_clip_texts:
                data[name] = _Clip(motion, len(motion), whole_clip_texts)
                names.append(name)
                lengths.append(len(motion))

        order = np.argsort(lengths, kind="stable")
        self.name_list = [names[i] for i in order]
        self.length_arr = np.asarray(lengths)[order]
        self.data = data
        self.reset_max_len(self.max_length)

    def reset_max_len(self, length: int) -> None:
        assert length <= self.cfg.max_motion_length
        self.pointer = int(np.searchsorted(self.length_arr, length))
        self.max_length = length

    def inv_transform(self, data: np.ndarray) -> np.ndarray:
        return data * self.std + self.mean

    def __len__(self) -> int:
        return len(self.name_list) - self.pointer

    def captions(self) -> List[str]:
        """Every distinct caption in corpus order: `cli.train_t2m` embeds
        each caption once (the text set is static)."""
        seen, out = set(), []
        for name in self.name_list:
            for t in self.data[name].text:
                if t["caption"] not in seen:
                    seen.add(t["caption"])
                    out.append(t["caption"])
        return out

    def _crop(self, clip: _Clip):
        """Unit-length crop + z-norm + zero-pad (the shared tail of
        `__getitem__`, dataset.py:313-340). Returns (motion (T,C) f32,
        m_length, chosen text entry)."""
        motion, m_length = clip.motion, clip.length
        text = clip.text[self.rng.integers(len(clip.text))]
        unit = self.cfg.unit_length
        coin_double = unit < 10 and self.rng.integers(3) == 2
        m_length = (m_length // unit - (1 if coin_double else 0)) * unit
        start = self.rng.integers(0, len(motion) - m_length + 1)
        motion = motion[start: start + m_length]
        motion = (motion - self.mean) / self.std
        if m_length < self.cfg.max_motion_length:
            motion = np.concatenate(
                [motion,
                 np.zeros((self.cfg.max_motion_length - m_length,
                           motion.shape[1]))],
                axis=0,
            )
        return motion.astype(np.float32), m_length, text

    def train_batches(self, batch_size: int,
                      text_embs: Dict[str, np.ndarray]) -> Iterator[dict]:
        """Infinite train iterator: {'motion' (B, T, C), 'text_emb'
        (B, clip_dim), 'lengths' (B,)} — the `make_t2m_cond_builder`
        layout. `text_embs` maps caption -> precomputed CLIP embedding."""
        n = len(self)
        while True:
            idx = self.rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                rows = [self._crop(self.data[self.name_list[self.pointer + j]])
                        for j in idx[i: i + batch_size]]
                yield {
                    "motion": np.stack([r[0] for r in rows]),
                    "text_emb": np.stack(
                        [text_embs[r[2]["caption"]] for r in rows]
                    ).astype(np.float32),
                    "lengths": np.asarray([r[1] for r in rows], np.int32),
                }

    def __getitem__(self, item: int):
        clip = self.data[self.name_list[self.pointer + item]]
        motion, m_length = clip.motion, clip.length
        text = clip.text[self.rng.integers(len(clip.text))]
        caption, tokens = text["caption"], text["tokens"]

        if len(tokens) < self.cfg.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens = tokens + ["unk/OTHER"] * (self.cfg.max_text_len + 2 - sent_len)
        else:
            tokens = ["sos/OTHER"] + tokens[: self.cfg.max_text_len] + ["eos/OTHER"]
            sent_len = len(tokens)
        vecs = [self.w_vectorizer[t] for t in tokens]
        word_embeddings = np.stack([v[0] for v in vecs])
        pos_one_hots = np.stack([v[1] for v in vecs])

        unit = self.cfg.unit_length
        coin_double = unit < 10 and self.rng.integers(3) == 2
        m_length = (m_length // unit - (1 if coin_double else 0)) * unit
        start = self.rng.integers(0, len(motion) - m_length + 1)
        motion = motion[start: start + m_length]
        motion = (motion - self.mean) / self.std
        if m_length < self.cfg.max_motion_length:
            motion = np.concatenate(
                [motion,
                 np.zeros((self.cfg.max_motion_length - m_length, motion.shape[1]))],
                axis=0,
            )
        return (word_embeddings, pos_one_hots, caption, sent_len, motion,
                m_length, "_".join(tokens))

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[dict]:
        """Yield evaluator-ready numpy batches (the eval_humanml loader
        contract)."""
        idx = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            rows = [self[j] for j in idx[i: i + batch_size]]
            yield {
                "word_embs": np.stack([r[0] for r in rows]).astype(np.float32),
                "pos_ohot": np.stack([r[1] for r in rows]).astype(np.float32),
                "captions": [r[2] for r in rows],
                "cap_lens": np.asarray([r[3] for r in rows]),
                "motions": np.stack([r[4] for r in rows]).astype(np.float32),
                "m_lens": np.asarray([r[5] for r in rows]),
                "tokens": [r[6] for r in rows],
            }
