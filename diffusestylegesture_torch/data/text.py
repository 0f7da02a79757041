"""Per-frame text features from word-aligned TSVs + fastText vectors, numpy.

The port's own copy of `diffusestylegesture_tpu/data/text.py`. Parity with
the reference text featurizers:
  * `load_tsv_unclipped` / `load_tsv` (BEAT, 301-d: 300 fastText + silence
    flag) — `process_BEAT_bvh.py:234-281`;
  * TWH variant (302-d: + laughter '#' flag in the second-to-last column)
    — `process_TWH_bvh.py:134-198`;
  * `load_wordvectors` streaming .vec reader — `process_BEAT_bvh.py:223-231`
    (with an npz cache so the ~3-minute crawl-300d-2M load happens once).

Framing quirks preserved: int() truncation of start/end·fps frames,
punctuation stripping, multi-word splitting by equal duration, missing
words leaving zero vectors while still clearing the silence flag.
"""
from __future__ import annotations

import io
import os
import string
from typing import Dict, List, Optional, Tuple

import numpy as np

FPS = 30


def load_tsv_unclipped(tsvfile: str) -> List[Tuple[float, float, str]]:
    sentence = []
    with open(tsvfile, "r") as f:
        for line in f.readlines():
            parts = line.strip().split("\t")
            if len(parts) == 3:
                sentence.append((float(parts[0]), float(parts[1]), parts[2]))
    return sentence


def _clean_word(raw: str) -> str:
    word = raw.translate(str.maketrans("", "", string.punctuation))
    word = word.strip()
    word = word.replace("  ", " ")
    if len(word) > 0 and word[0] == " ":
        word = word[1:]
    return word


def load_tsv(
    tsvpath: str,
    word2vector: Dict[str, np.ndarray],
    clip_len: int,
    laughter_flag: bool = False,
) -> np.ndarray:
    """(clip_len, 301) BEAT layout or (clip_len, 302) TWH layout."""
    extra = 2 if laughter_flag else 1
    feats = np.zeros([clip_len, 300 + extra])
    feats[:, -1] = 1  # silence flag default on

    for start, end, raw_word in load_tsv_unclipped(tsvpath):
        has_laughter = "#" in raw_word
        start_frame = int(start * FPS)
        end_frame = int(end * FPS)
        feats[start_frame:end_frame, -1] = 0

        word = _clean_word(raw_word)
        if " " in word:
            ww = word.split(" ")
            subword_duration = (end_frame - start_frame) / len(ww)
            for j, w in enumerate(ww):
                vector = word2vector.get(w)
                if vector is not None:
                    ss = start_frame + int(subword_duration * j)
                    ee = start_frame + int(subword_duration * (j + 1))
                    feats[ss:ee, :300] = vector
        else:
            vector = word2vector.get(word)
            if vector is not None:
                feats[start_frame:end_frame, :300] = vector
        if laughter_flag:
            feats[start_frame:end_frame, -2] = has_laughter
    return feats


def load_word_vectors(fname: str, cache: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Stream a fastText .vec file → {word: (300,)}; optional npz cache."""
    if cache and os.path.exists(cache):
        blob = np.load(cache, allow_pickle=False)
        return {w: v for w, v in zip(blob["words"], blob["vectors"])}
    data: Dict[str, np.ndarray] = {}
    with io.open(fname, "r", encoding="utf-8", newline="\n", errors="ignore") as fin:
        header = fin.readline().split()
        _n, d = int(header[0]), int(header[1])
        for line in fin:
            tokens = line.rstrip().split(" ")
            if len(tokens) == d + 1:
                data[tokens[0]] = np.array([float(v) for v in tokens[1:]])
    if cache:
        words = np.array(list(data.keys()))
        vectors = np.stack(list(data.values())).astype(np.float32)
        # atomic publish: concurrent prepare-data workers gate on
        # os.path.exists(cache), so a direct np.savez would let a reader
        # see (and crash on) a half-written zip
        tmp = f"{cache}.tmp.{os.getpid()}"
        np.savez(tmp, words=words, vectors=vectors)
        # np.savez appends .npz when missing; the tmp name has no .npz
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   cache)
    return data
