"""Dataset preparation CLI.

  python -m diffusestylegesture_torch.cli.prepare_data --dataset ZEGGS \\
      --source ./zeggs_raw --target ./data/zeggs_processed [--workers 4] \\
      [--normalize_loudness]
  python -m diffusestylegesture_torch.cli.prepare_data --dataset TWH \\
      --source ./twh_raw --target ./data/TWH_v0.npz --metadata metadata.csv \\
      --word_vectors crawl-300d-2M.vec --wavlm_path WavLM-Large.pt [--workers 4]

Port of `diffusestylegesture_tpu/cli/prepare_data.py`:

* ZEGGS (reference `main/mydiffusion_zeggs/zeggs_data_to_lmdb.py`): paired
  `<name>.wav` + `<name>.bvh` clips → normalized npz shards and mean/std
  (`data/zeggs.py::build_zeggs_dataset`), host numpy only.
  `--normalize_loudness` runs the EBU R128 pass in place of the reference's
  external `ffmpeg-normalize` pre-step.
* BEAT / TWH (reference `process_BEAT_bvh.py:355-441`,
  `process_TWH_bvh.py:271-355`): triples `<name>.bvh` + 16 kHz `<name>.wav` +
  word timings `<name>.tsv` → one dataset store (`--target`, an `.npz`, see
  `data/h5_loader.py`) and `<target root>_mean.npy` / `_std.npy`. WavLM
  (`--wavlm_path`) runs on the card (`--device`, cuda by default), serially in
  this process; without it its 1024 features are zeros, as in the JAX CLI.
  The host features (BVH parse and features, MFCC, log-mel, prosody, onsets,
  text rows) run in `--workers` spawned processes, which use no card. BEAT
  speaker slots come from the 1-based file names (`2_scott_…` → slot 1), TWH
  slots from `--metadata`; a slot outside `--num_speakers` stops the run.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description="DiffuseStyleGesture data preparation (PyTorch port)")
    p.add_argument("--dataset", choices=["ZEGGS", "BEAT", "TWH"], required=True)
    p.add_argument("--source", required=True,
                   help="directory of paired .wav / .bvh clips (+ .tsv for BEAT/TWH)")
    p.add_argument("--target", required=True,
                   help="ZEGGS: output directory; BEAT/TWH: the dataset store's .npz path")
    p.add_argument("--fps", type=int, default=None)
    p.add_argument("--word_vectors", default=None,
                   help="fastText .vec file (BEAT/TWH); zero vectors without it")
    p.add_argument("--metadata", default=None, help="GENEA metadata csv (TWH speakers)")
    p.add_argument("--num_speakers", type=int, default=17)
    p.add_argument("--wavlm_path", default=None,
                   help="WavLM .pt (BEAT/TWH); zero features without it")
    p.add_argument("--workers", type=int, default=0,
                   help="featurize the clips in N spawned processes (same output as serial)")
    p.add_argument("--normalize_loudness", action="store_true",
                   help="ZEGGS: EBU R128 normalization to -23 LUFS (the reference's "
                        "ffmpeg-normalize pre-step)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="BEAT/TWH: where WavLM runs")
    args = p.parse_args(argv)

    if args.dataset == "ZEGGS":
        from ..data import build_zeggs_dataset

        stats = build_zeggs_dataset(args.source, args.target, fps=args.fps or 20,
                                    workers=args.workers, loudnorm=args.normalize_loudness)
        print("mean/std written;", stats["mean"].shape)
        return stats
    return prepare_beat_twh(args)


def speaker_slot(name: str, dataset: str, metadata) -> int:
    """0-based speaker slot of a clip: BEAT from its 1-based file name, TWH
    from the metadata (0 for a clip it does not list, or without it)."""
    if dataset == "BEAT":
        return int(name.split("_")[0]) - 1
    if metadata is not None and name in metadata:
        return metadata[name][1]
    return 0


def prepare_beat_twh(args) -> Dict:
    """(bvh, wav, tsv) triples → the store and mean/std. Returns {'target',
    'clips', 'mean', 'std', 'seconds': {'total', 'wavlm' (card, serial),
    'host_wall' (the pool's wall time), 'bvh_parse', 'gesture', 'audio_text'
    (summed over the clips in the workers)}}."""
    from ..data import build_h5_dataset, load_wav_16k
    from ..data.beat_twh import load_metadata
    from ..data.h5_loader import gesture_statistics
    from ..data.text import load_word_vectors
    from ..device import resolve_device

    t_start = time.perf_counter()
    device = resolve_device(args.device)
    parallel = bool(args.workers and args.workers > 1)
    w2v = {}
    if args.word_vectors:
        # load once here so the npz cache exists; with workers each loads the
        # cache itself, and the parent's copy is dropped (it would double the RAM)
        w2v = load_word_vectors(args.word_vectors, cache=args.word_vectors + ".npz")
        if parallel:
            w2v = {}
    metadata = load_metadata(args.metadata)[1] if args.metadata else None

    wavlm = wavlm_fn = None
    if args.wavlm_path:
        from ..models.convert import load_wavlm_checkpoint
        from ..models.wavlm import make_twh_wavlm_fn

        _, wavlm = load_wavlm_checkpoint(args.wavlm_path, device=device)
        wavlm_fn = make_twh_wavlm_fn()

    tasks = []
    wavlm_s = 0.0
    for bvh_path in sorted(glob.glob(os.path.join(args.source, "*.bvh"))):
        name = os.path.splitext(os.path.basename(bvh_path))[0]
        wav_path = os.path.join(args.source, name + ".wav")
        tsv_path = os.path.join(args.source, name + ".tsv")
        if not (os.path.exists(wav_path) and os.path.exists(tsv_path)):
            print("skip (missing wav/tsv):", name)
            continue
        slot = speaker_slot(name, args.dataset, metadata)
        if not 0 <= slot < args.num_speakers:
            # an aliased slot would merge two speakers' identity conditioning
            raise SystemExit(f"{name}: speaker slot {slot} outside --num_speakers "
                             f"{args.num_speakers} (BEAT names are 1-based): raise "
                             "--num_speakers to cover the corpus")
        onehot = np.zeros(args.num_speakers, np.float32)
        onehot[slot] = 1
        feats = None
        if wavlm is not None:
            t0 = time.perf_counter()
            with torch.inference_mode():
                wav = torch.as_tensor(load_wav_16k(wav_path), device=device)
                feats = wavlm_fn(wavlm, wav).cpu().numpy()
            wavlm_s += time.perf_counter() - t0
        tasks.append((bvh_path, wav_path, tsv_path, onehot, args.dataset, feats))
    if not tasks:
        raise SystemExit("no usable (bvh, wav, tsv) triples found")

    t0 = time.perf_counter()
    if parallel:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=args.workers, mp_context=mp.get_context("spawn"),
                                 initializer=_worker_init, initargs=(args.word_vectors,)) as ex:
            results = list(ex.map(_worker_clip, tasks))
    else:
        results = [_clip(t, w2v) for t in tasks]
    host_wall = time.perf_counter() - t0
    clips = [c for c, _ in results]
    for t, (c, _) in zip(tasks, results):
        print("processed:", os.path.basename(t[0]), {k: v.shape for k, v in c.items()})

    build_h5_dataset(args.target, clips)
    mean, std = gesture_statistics(args.target)
    root = os.path.splitext(args.target)[0]
    np.save(root + "_mean.npy", mean)
    np.save(root + "_std.npy", std)
    seconds = {k: sum(tm[k] for _, tm in results) for k in ("bvh_parse", "gesture", "audio_text")}
    seconds.update(total=time.perf_counter() - t_start, wavlm=wavlm_s, host_wall=host_wall)
    print(f"wrote {args.target} ({len(clips)} clips), mean/std {mean.shape}; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f" (WavLM on {device}; host features in "
          + (f"{args.workers} workers)" if parallel else "this process)"))
    return {"target": args.target, "clips": clips, "mean": mean, "std": std,
            "seconds": seconds}


_WORKER_W2V: Dict = {}  # a spawned worker's word vectors, set once by `_worker_init`


def _worker_init(word_vectors) -> None:
    """Spawned worker: hide the cards (its work is host numpy), and load the
    cached word-vector table once; it is too large to send with each task."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    global _WORKER_W2V
    if word_vectors:
        from ..data.text import load_word_vectors

        _WORKER_W2V = load_word_vectors(word_vectors, cache=word_vectors + ".npz")


def _worker_clip(task) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    return _clip(task, _WORKER_W2V)


def _clip(task, w2v) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """One clip's store dict and the seconds of its host feature parts."""
    from ..data import load_wav_16k
    from ..data.beat_twh import build_beat_twh_clip

    bvh_path, wav_path, tsv_path, onehot, dataset, wavlm_feats = task
    timings: Dict[str, float] = {}
    clip = build_beat_twh_clip(bvh_path, load_wav_16k(wav_path), 16000, tsv_path, w2v, onehot,
                               dataset=dataset, wavlm_features=wavlm_feats, timings=timings)
    return clip, timings


if __name__ == "__main__":
    main()
