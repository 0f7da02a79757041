"""Gesture evaluation CLI: FGD, diversity, KID, precision/recall, beat
alignment and the frozen-draw census of a generated set against a reference.

  python -m diffusestylegesture_torch.cli.eval \\
      --generated gen_dir/ --reference ref_dir/ [--wav audio_dir/] \\
      [--fps 20] [--window 40] [--embedding autoencoder] [--kid]

Port of `diffusestylegesture_tpu/cli/eval.py`, with its flags and `--device`
(the card by default; the autoencoder trains and embeds there). `--generated`
/ `--reference` take a directory of `.npy` pose-feature clips (T, D) or one
`.npy`; clips are paired by file stem. Reported, as one JSON line with the JAX
CLI's keys:

  * FGD between the windowed feature distributions: over the flattened
    `--window`-frame windows (`--embedding raw`), or over the latent of an
    autoencoder trained on the reference set (`--embedding autoencoder`,
    Yoon et al. 2020), to which raw windows above 8192 dimensions switch;
  * the diversity of both sets; with `--kid`, KID and improved
    precision/recall in the same feature space;
  * with `--wav` (a directory of wavs named by stem), the beat alignment
    against audio onsets of the generated and of the reference set;
  * velocity retention per stem-matched pair: the mean |frame delta| of the
    generated clip over the reference clip's. A ratio under
    `--frozen_vel_ratio` is frozen motion, a failure FGD can hide (distilled
    students emitting a static pose on ~10% of noise draws still averaged
    within FGD tolerance, as the JAX package measured).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..eval.metrics import beat_alignment, diversity, frechet_distance


def load_clips(path: str):
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        return {f[:-4]: np.load(os.path.join(path, f)) for f in files}
    return {os.path.basename(path)[:-4]: np.load(path)}


def windowed_features(clips, window: int, stride: int):
    """{name: (T, D)} → (N, window·D) stacked windows."""
    rows = []
    for arr in clips.values():
        arr = np.asarray(arr, np.float32)
        for s in range(0, max(1, len(arr) - window + 1), stride):
            w = arr[s: s + window]
            if len(w) == window:
                rows.append(w.reshape(-1))
    if not rows:
        raise SystemExit(f"no complete {window}-frame windows found")
    return np.stack(rows)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gesture metrics (FGD etc.), PyTorch/CUDA")
    p.add_argument("--generated", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--wav", default=None, help="dir of wavs matched by stem")
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--window", type=int, default=40)
    p.add_argument("--stride", type=int, default=20)
    p.add_argument("--sigma", type=float, default=0.1)
    p.add_argument("--embedding", choices=["raw", "autoencoder"], default="raw",
                   help="FGD feature space: raw windows, or the latent of an autoencoder "
                        "trained on the reference set (Yoon et al. 2020 convention)")
    p.add_argument("--ae_steps", type=int, default=500)
    p.add_argument("--ae_latent", type=int, default=128)
    p.add_argument("--ae_cache", default=None,
                   help="directory to save/load the trained autoencoder, keyed by window, "
                        "latent and steps: evals against the SAME reference set share one "
                        "latent space. Do not reuse across reference sets")
    p.add_argument("--frozen_vel_ratio", type=float, default=0.25,
                   help="a generated clip whose mean |frame delta| falls below this fraction "
                        "of its stem-matched reference clip's counts as frozen motion")
    p.add_argument("--kid", action="store_true",
                   help="also report KID (polynomial MMD) and improved precision/recall over "
                        "the same feature space")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gen = load_clips(args.generated)
    ref = load_clips(args.reference)

    gf = windowed_features(gen, args.window, args.stride)
    rf = windowed_features(ref, args.window, args.stride)

    if args.embedding == "raw" and rf.shape[1] > 8192:
        # raw windows of real gesture features (40 × 1141 = 45,640-d) exceed what
        # covariance-based FGD can handle: train the embedding instead
        print(f"note: raw {rf.shape[1]}-d windows exceed the covariance-FGD limit — "
              "switching to --embedding autoencoder", file=sys.stderr)
        args.embedding = "autoencoder"

    if args.embedding == "autoencoder":
        from ..eval.embedding import (AEConfig, GestureAutoencoder, embed_windows,
                                      train_autoencoder)

        D = next(iter(ref.values())).shape[1]
        cfg = AEConfig(window=args.window, feat_dim=D, latent=args.ae_latent)
        rw = rf.reshape(-1, args.window, D)
        gw = gf.reshape(-1, args.window, D)
        model = None
        if args.ae_cache:
            # keyed by the autoencoder's configuration: a smoke run's few-step
            # autoencoder must not be restored by a later real run (another
            # latent space, another FGD scale)
            cache_path = os.path.abspath(os.path.join(
                args.ae_cache, f"ae_params_w{args.window}_l{args.ae_latent}_s{args.ae_steps}.pt"))
            if os.path.exists(cache_path):
                model = GestureAutoencoder(cfg)
                model.load_state_dict(torch.load(cache_path, map_location="cpu",
                                                 weights_only=True))
                model = model.to(device).eval()
        if model is None:
            model, _ = train_autoencoder(rw, cfg, num_steps=args.ae_steps, device=device)
            if args.ae_cache:
                os.makedirs(args.ae_cache, exist_ok=True)
                torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                           cache_path)
        gf = embed_windows(model, gw)
        rf = embed_windows(model, rw)

    # velocity retention over stem-matched pairs, on the raw pose features
    vel_ratios = {}
    for name, motion in gen.items():
        if name not in ref or len(motion) < 2 or len(ref[name]) < 2:
            continue
        rv = float(np.abs(np.diff(np.asarray(ref[name], np.float64), axis=0)).mean())
        gv = float(np.abs(np.diff(np.asarray(motion, np.float64), axis=0)).mean())
        vel_ratios[name] = gv / max(rv, 1e-12)
    frozen = sorted(n for n, r in vel_ratios.items() if r < args.frozen_vel_ratio)

    out = {
        "fgd": frechet_distance(gf, rf),
        "embedding": args.embedding,
        "diversity_generated": diversity(gf, min(300, len(gf) * 2)),
        "diversity_reference": diversity(rf, min(300, len(rf) * 2)),
        "n_windows_generated": int(len(gf)),
        "n_windows_reference": int(len(rf)),
        "velocity_retention_min": min(vel_ratios.values()) if vel_ratios else None,
        "velocity_retention_mean": (float(np.mean(list(vel_ratios.values())))
                                    if vel_ratios else None),
        "velocity_clips_matched": len(vel_ratios),
        "frozen_clips": len(frozen),
        "frozen_clip_stems": frozen,
    }

    if args.kid:
        from ..eval.unconstrained import kid, precision_and_recall

        n = min(len(gf), len(rf))
        kid_mean, kid_std = kid(rf, gf, n_subsets=100, subset_size=min(1000, n))
        precision, recall = precision_and_recall(gf, rf)
        out.update(kid_mean=kid_mean, kid_std=kid_std, precision=precision, recall=recall)

    if args.wav:
        from ..audio.features import detect_onsets
        from ..data import load_wav_16k

        def score_set(clips):
            scores = []
            for name, motion in clips.items():
                wav_path = os.path.join(args.wav, name + ".wav")
                if not os.path.exists(wav_path):
                    continue
                s = beat_alignment(motion, detect_onsets(load_wav_16k(wav_path)), args.fps,
                                   sigma=args.sigma)
                if np.isfinite(s):
                    scores.append(s)
            return scores

        scores = score_set(gen)
        out["beat_alignment"] = float(np.mean(scores)) if scores else None
        out["beat_alignment_clips"] = len(scores)
        # the reference set's own alignment on the same audio: without it the
        # generated score has no scale (its ceiling depends on how sharp the
        # corpus's strokes are)
        ref_scores = score_set(ref)
        out["beat_alignment_reference"] = float(np.mean(ref_scores)) if ref_scores else None

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
