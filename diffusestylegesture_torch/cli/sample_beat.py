"""BEAT/TWH sampling CLI (DiffuseStyleGesture / + / ++), on the card by default.

Usage (mirrors `BEAT-TWH-main/mydiffusion_beat_twh/sample.py:271-344` and the
JAX package's `cli/sample_beat.py`, whose flags it takes, plus `--device`):
  python -m diffusestylegesture_torch.cli.sample_beat --config configs/beat_twh.yml \\
      --dataset TWH --name DiffuseStyleGesture+ --model_path model001200000.pt \\
      --wav clip.wav --tsv clip.tsv --word_vectors crawl-300d-2M.vec \\
      --wavlm_path WavLM-Large.pt --seed_gesture_npy seed.npy \\
      --mean_npy mean.npy --std_npy std.npy --speaker 5

The per-frame features are a precomputed text+audio npy (`--textaudio_npy`,
the reference's `audio_*.npy + text_*.npy` concatenation) or are built here
from a wav and its word timings (`--wav --tsv`): the 1133-d audio vector
(`data/beat_twh.py`, host numpy, with WavLM-Large features from `--wavlm_path`
run on the card in float32, zeros without it) and the 301/302-d text vector
(`data/text.py`). `--model_path` is a reference-layout `.pt`, or a directory
holding the port's `model.pt` (`scripts/convert_orbax_to_torch.py` writes one
from an orbax checkpoint of the JAX package). `--serve_fast` runs the trunk
in kernel B's bf16-operand mode with tanh-approximated GELU; WavLM stays
float32, as in the JAX CLI. The quality gate of the dataset's family is
checked before any model is loaded. On the card the engine runs as CUDA
graphs captured at first use (`sample/engine_beat.py`). The output is the
position block of the motion, `<stamp>_spk<N>_motion.npy`; a BVH is written
from it by `motion/pipeline.py::twh_features_to_bvh` / `beat_features_to_bvh`
with the pipeline `twh_features` / `beat_features` fitted on a training BVH.
`--model_path <save_dir>/<step>` serves a checkpoint of `cli/train.py`.
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np
import torch

from .. import diffusion as D
from ..config import apply_beat_twh_derivations, load_yaml_config
from ..device import resolve_device
from ..models.convert import load_reference_mdm_plus, load_wavlm_checkpoint
from ..models.mdm_plus import MDMPlusConfig
from ..sample import BeatEngineConfig, BeatTwhSampler, prepare_seed_gesture
from ..sample.quality_gate import check_mode
from .sample import model_checkpoint

VARIANTS = {
    "DiffuseStyleGesture": "attention3",
    "DiffuseStyleGesture+": "attention4",
    "DiffuseStyleGesture++": "attention5",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DiffuseStyleGesture+ sampling (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--dataset", default=None, help="BEAT | TWH (overrides the yaml)")
    p.add_argument("--name", default=None,
                   help="DiffuseStyleGesture | DiffuseStyleGesture+ | DiffuseStyleGesture++")
    p.add_argument("--model_path", required=True,
                   help="reference-layout MDM .pt, or a directory with the port's model.pt")
    p.add_argument("--textaudio_npy", default=None,
                   help="precomputed fused text+audio features (T, A)")
    p.add_argument("--wav", default=None)
    p.add_argument("--tsv", default=None, help="word timings: start<TAB>end<TAB>word lines")
    p.add_argument("--word_vectors", default=None, help="fastText .vec file for the tsv words")
    p.add_argument("--wavlm_path", default=None,
                   help="WavLM .pt; zeros stand in for its features when omitted")
    p.add_argument("--seed_gesture_npy", required=True,
                   help="(n_seed+2, motion_dim) raw reference clip")
    p.add_argument("--mean_npy", required=True)
    p.add_argument("--std_npy", required=True)
    p.add_argument("--speaker", type=int, default=0)
    p.add_argument("--max_len", type=int, default=0)
    p.add_argument("--seed", type=int, default=123456)
    p.add_argument("--serve_fast", action="store_true",
                   help="bf16 trunk (kernel B's mxu_bf16 mode) + tanh-approx GELU")
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "plms", "dpmpp"])
    p.add_argument("--respace", type=int, default=0,
                   help="respace the schedule to N timesteps (ddimN striding)")
    p.add_argument("--allow_degraded", action="store_true",
                   help="serve a mode the quality gate measured as degraded")
    p.add_argument("--save_dir", default="./sample_dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def mdm_plus_config(cfg, serve_fast: bool = False) -> MDMPlusConfig:
    """The denoiser's config from a derived yaml (`apply_beat_twh_derivations`)."""
    return MDMPlusConfig(
        njoints=cfg.njoints, latent_dim=cfg.latent_dim, ff_size=cfg.get("ff_size", 1024),
        num_layers=cfg.get("num_layers", 8), num_heads=cfg.get("num_heads", 4),
        n_seed=cfg.n_seed, cond_mode=cfg.cond_mode, cond_mask_prob=cfg.cond_mask_prob,
        source_audio_dim=cfg.audio_feature_dim, audio_feat_dim=cfg.audio_feat_dim_latent,
        style_dim_in=cfg.style_dim, moe_experts=cfg.get("moe_experts", 0),
        dtype=torch.bfloat16 if serve_fast else torch.float32,
        activation="gelu_tanh" if serve_fast else "gelu")


def live_features(cfg, wav_path: str, tsv_path: str, word_vectors, wavlm_path,
                  device: torch.device):
    """wav + tsv → ((T, audio_feature_dim) features, host seconds, WavLM seconds)."""
    from ..data import load_wav_16k
    from ..data.beat_twh import load_audio_features
    from ..data.text import load_tsv, load_word_vectors
    from ..models.wavlm import make_twh_wavlm_fn

    wav = load_wav_16k(wav_path)
    wavlm_feats, wavlm_s = None, 0.0
    if wavlm_path:
        _, wavlm = load_wavlm_checkpoint(wavlm_path, device=device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            wavlm_feats = make_twh_wavlm_fn()(wavlm, torch.as_tensor(wav, device=device))
            wavlm_feats = wavlm_feats.cpu().numpy()
        wavlm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    audio_feats = load_audio_features(wav, 16000, wavlm_feats)
    w2v = load_word_vectors(word_vectors) if word_vectors else {}
    text = load_tsv(tsv_path, w2v, len(audio_feats), laughter_flag=cfg.dataset == "TWH")
    textaudio = np.concatenate([audio_feats, text], axis=-1).astype(np.float32)
    features_s = time.perf_counter() - t0
    if textaudio.shape[1] != cfg.audio_feature_dim:
        raise SystemExit(f"live features are {textaudio.shape[1]}-d, the {cfg.dataset} model "
                         f"takes {cfg.audio_feature_dim}")
    return textaudio, features_s, wavlm_s


def main(argv=None):
    """Returns {'path': the written npy, 'motion': (B, T, motion_dim) array,
    'generate_seconds': wall time of the engine call, 'capture_seconds': the
    part of it spent capturing CUDA graphs, 'features_seconds': host feature
    time of the live path, 'wavlm_seconds': its WavLM time (both 0 on the npy
    path)}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_beat_twh_derivations(
        load_yaml_config(args.config, {"dataset": args.dataset, "name": args.name}))

    # BEAT has no family in the shipped manifest: its fast modes pass with a note
    status, message = check_mode(args.sampler, args.respace, cfg.diffusion_steps,
                                 family=cfg.dataset.lower())
    if status == "degraded" and not args.allow_degraded:
        raise SystemExit(f"REFUSED: {message}")
    if status != "baseline":
        print(("note: " if status == "unknown" else "") + message)
    if not args.textaudio_npy and not (args.wav and args.tsv):
        raise SystemExit("provide --textaudio_npy or (--wav and --tsv)")

    os.makedirs(args.save_dir, exist_ok=True)
    model = load_reference_mdm_plus(model_checkpoint(args.model_path, use_ema=False),
                                    mdm_plus_config(cfg, args.serve_fast), device=device)
    mean = np.load(args.mean_npy)
    std = np.load(args.std_npy)
    features_s = wavlm_s = 0.0
    if args.textaudio_npy:
        textaudio = np.load(args.textaudio_npy)
    else:
        textaudio, features_s, wavlm_s = live_features(
            cfg, args.wav, args.tsv, args.word_vectors, args.wavlm_path, device)
    seed = prepare_seed_gesture(np.load(args.seed_gesture_npy)[: cfg.n_seed + 2], mean, std)
    style = np.zeros(cfg.style_dim, np.float32)
    style[args.speaker] = 1.0

    noise_schedule = cfg.get("noise_schedule", "cosine")
    betas = D.named_beta_schedule(noise_schedule, cfg.diffusion_steps)
    if args.respace:
        sched = D.spaced_schedule(betas, D.space_timesteps(cfg.diffusion_steps,
                                                           f"ddim{args.respace}"), device=device)
    else:
        sched = D.Schedule.create(betas, device=device)

    def model_apply(mdm, x, t, cond, uncond=None):
        return mdm(x, t, cond, uncond=uncond)

    variant = VARIANTS[cfg.name]
    sampler = BeatTwhSampler(
        model_apply, sched,
        BeatEngineConfig(n_poses=cfg.n_poses, n_seed=cfg.n_seed, njoints=cfg.njoints,
                         audio_dim=cfg.audio_feature_dim, variant=variant,
                         sampler=args.sampler,
                         motion_feature_division=cfg.njoints // cfg.motion_dim),
        device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = sampler.generate(model, textaudio, seed, style[None], generator, mean, std,
                           seed_last=seed if variant == "attention5" else None,
                           max_len=args.max_len)
    seconds = time.perf_counter() - t0  # `generate` returns host numpy: the device is done
    capture = sampler.capture_seconds
    print(f"generated {out.shape[0]}x{out.shape[1]} frames in {seconds:.3f} s "
          f"({out.shape[0] * out.shape[1] / seconds:.1f} frames/s) on {device}"
          + (f", {capture:.3f} s of it capturing CUDA graphs" if sampler.graphs else ""))

    prefix = datetime.now().strftime("%Y%m%d_%H%M%S") + f"_spk{args.speaker}"
    npy_path = os.path.join(args.save_dir, prefix + "_motion.npy")
    np.save(npy_path, out[0])
    print("wrote", npy_path, out.shape)
    return {"path": npy_path, "motion": out, "generate_seconds": seconds,
            "capture_seconds": capture, "features_seconds": features_s,
            "wavlm_seconds": wavlm_s}


if __name__ == "__main__":
    main()
