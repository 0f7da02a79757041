"""Sampling CLI: 16 kHz wav → ZEGGS gestures → .bvh, on the card by default.

Usage (mirrors `main/mydiffusion_zeggs/sample.py:400-420` and the JAX
package's `cli/sample.py`, whose flags it takes, `--aot_dir` aside):
  python -m diffusestylegesture_torch.cli.sample --config configs/zeggs.yml \\
      --model_path model000450000.pt --audiowavlm_path 015_Happy_4_x_1_0.wav \\
      --max_len 320

`--model_path` is a reference-layout MDM `.pt`, or a directory written by
`scripts/convert_orbax_to_torch.py` from any orbax layout of the JAX package
(`model.pt`, `model_ema.pt` when the TrainState held EMA params, and a
distilled student's `schedule.json`); a MoE-trained checkpoint serves with
its expert count (`resolve_moe_config`). The WavLM checkpoint is the yaml's
`wavlm_path`. The quality gate is checked before any model is loaded. On the
card the engine runs as CUDA graphs captured at first use; a graph lives in
its process, so the JAX CLI's `--aot_dir` (ahead-of-time snapshots across
processes) has no counterpart: capture takes seconds, and the compiled
kernels are cached in `diffusestylegesture_torch/_build/`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from .. import diffusion as D
from ..audio import normalize_loudness
from ..config import load_yaml_config
from ..data import load_wav_16k
from ..device import resolve_device
from ..models.convert import (load_reference_mdm, load_wavlm_checkpoint,
                              read_reference_state_dict)
from ..models.mdm import MDMConfig
from ..models.wavlm import make_zeggs_wavlm_fn
from ..motion import zeggs_features as zf
from ..sample import ZeggsEngineConfig, ZeggsSampler
from ..sample.quality_gate import check_key, check_mode
from ..sample.styles import blend_styles


def parse_style(spec: str) -> np.ndarray:
    """Style token ('Happy') or additive blend ('Happy:0.6,Sad:0.4')."""
    if ":" in spec:
        names, weights = zip(*(part.split(":") for part in spec.split(",")))
        return blend_styles(names, [float(w) for w in weights])
    v = zf.style_onehot(spec)
    if v is None:
        raise SystemExit(f"unknown style token {spec!r}")
    return v


def _sanitize(tok: str) -> str:
    return tok.replace(":", "").replace(",", "-").replace(";", "-")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DiffuseStyleGesture sampling (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--model_path", required=True,
                   help="reference-layout MDM .pt, or a directory written by "
                        "scripts/convert_orbax_to_torch.py (orbax params, TrainLoop or "
                        "distilled-student stage dir, converted)")
    p.add_argument("--audiowavlm_path", required=True)
    p.add_argument("--max_len", type=int, default=0)
    p.add_argument("--style", default=None,
                   help="style token (e.g. Happy) or additive blend 'Happy:0.6,Sad:0.4'")
    p.add_argument("--styles", default=None,
                   help="';'- or ','-separated style specs generated in one batch, one BVH "
                        "each; batched runs pin the crossfade width to 1")
    p.add_argument("--guidance_scale", type=float, default=0.0)
    p.add_argument("--skip_timesteps", type=int, default=0)
    p.add_argument("--seed", type=int, default=123456)
    p.add_argument("--save_dir", default="./sample_dir")
    p.add_argument("--use_ema", action="store_true",
                   help="sample from the EMA params of a converted TrainLoop checkpoint")
    p.add_argument("--serve_fast", action="store_true",
                   help="bf16 trunk (kernel B's mxu_bf16 mode) + tanh-approx GELU and a bf16 "
                        "WavLM; held within RMS/std 2e-2 of float32 (chip_smoke.py)")
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "plms", "dpmpp"])
    p.add_argument("--respace", type=int, default=0,
                   help="respace the schedule to N timesteps (ddimN striding)")
    p.add_argument("--allow_degraded", action="store_true",
                   help="serve a mode the quality gate measured as degraded")
    p.add_argument("--normalize_loudness", action="store_true",
                   help="EBU R128 normalize the input wav to -23 LUFS first (the "
                        "reference's ffmpeg-normalize pre-step; off by default, as on its "
                        "--audiowavlm_path demo path)")
    p.add_argument("--window_buckets", default=None,
                   help="comma-separated window-count buckets for the encoder batch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def mdm_config(cfg, audio_in_dim: int, serve_fast: bool = False) -> MDMConfig:
    """The denoiser's config from the yaml; `serve_fast` selects the bf16 trunk
    with tanh-approximated GELU (the JAX CLI's `dtype=bfloat16, activation="gelu_tanh"`)."""
    return MDMConfig(
        njoints=cfg.njoints, latent_dim=cfg.latent_dim, ff_size=cfg.get("ff_size", 1024),
        num_layers=cfg.get("num_layers", 8), num_heads=cfg.get("num_heads", 4),
        n_seed=cfg.n_seed, cond_mode=cfg.cond_mode, cond_mask_prob=cfg.cond_mask_prob,
        audio_feat=cfg.audio_feat, audio_in_dim=audio_in_dim,
        moe_experts=cfg.get("moe_experts", 0),
        dtype=torch.bfloat16 if serve_fast else torch.float32,
        activation="gelu_tanh" if serve_fast else "gelu")


def infer_moe_experts(state_dict) -> int:
    """Expert count of a MoE-trained checkpoint, 0 for a dense one: the
    leading dim of a layer's `moe.w1` stack (E, D, F), as `cli/train.py
    --moe_experts` writes it (JAX `cli/sample.py:92-103`)."""
    return next((int(v.shape[0]) for k, v in state_dict.items() if k.endswith(".moe.w1")), 0)


def resolve_moe_config(mcfg, state_dict, out=None):
    """`mcfg` with `moe_experts` set to the checkpoint's: when the yaml lacks
    the flag or disagrees, the checkpoint wins, in both directions (JAX
    `cli/sample.py:106-126`). Every serving-side CLI (sample, sample_beat,
    serve, distill) loads through it; any config with `moe_experts` works."""
    moe_e = infer_moe_experts(state_dict)
    if moe_e != mcfg.moe_experts:
        print("note: checkpoint is " + (f"MoE-trained ({moe_e} experts)" if moe_e else "dense")
              + " — overriding config", file=out or sys.stdout)
        mcfg = dataclasses.replace(mcfg, moe_experts=moe_e)
    return mcfg


def read_stage_schedule(model_path: str):
    """A distilled student's `schedule.json` (its exact DDIM grid and the base
    schedule it was distilled from), or None when `model_path` is no stage dir."""
    path = os.path.join(model_path, "schedule.json")
    if not (os.path.isdir(model_path) and os.path.exists(path)):
        return None
    with open(path) as f:
        return json.load(f)


def model_checkpoint(model_path: str, use_ema: bool) -> str:
    """The `.pt` to load: `model_path` itself, or from a converted directory
    `model_ema.pt` (with `use_ema`, when the checkpoint had EMA params) or
    `model.pt`."""
    if not os.path.isdir(model_path):
        if use_ema:
            print("note: --use_ema: a single .pt holds no EMA params; using its params")
        return model_path
    plain = os.path.join(model_path, "model.pt")
    if not os.path.exists(plain):
        raise SystemExit(
            f"{model_path} holds no model.pt: convert an orbax checkpoint or stage dir "
            "with scripts/convert_orbax_to_torch.py (beside the JAX package) first")
    ema = os.path.join(model_path, "model_ema.pt")
    if use_ema:
        if os.path.exists(ema):
            return ema
        print("note: --use_ema: the checkpoint holds no EMA params; using its params")
    return plain


def main(argv=None):
    """Returns {'paths': [written .bvh], 'poses': (B, T, njoints) array,
    'generate_seconds': wall time of the engine call, 'capture_seconds': the
    part of it spent capturing CUDA graphs}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config)

    # distilled student (stage dir): serve on its exact DDIM grid from
    # schedule.json, not a ddimN re-striding, and gate it under distillN
    # (the JAX CLI's order: --respace dropped before the ddpm → ddim switch)
    stage = read_stage_schedule(args.model_path)
    if stage is not None:
        grid = stage["use_timesteps"]
        if args.respace:
            print("note: --respace ignored for a distilled student "
                  "(schedule.json fixes the grid)")
            args.respace = 0
        if args.sampler == "ddpm":
            print(f"note: distilled student checkpoint — serving its {len(grid)}-step DDIM grid")
            args.sampler = "ddim"
        base_steps = int(stage.get("base_steps", cfg.diffusion_steps))
        status, message = check_key(f"distill{len(grid)}", diffusion_steps=base_steps)
    else:
        status, message = check_mode(args.sampler, args.respace, cfg.diffusion_steps)
    if status == "degraded" and not args.allow_degraded:
        raise SystemExit(f"REFUSED: {message}")
    if status != "baseline":
        print(("note: " if status == "unknown" else "") + message)

    os.makedirs(args.save_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.serve_fast else torch.float32
    wcfg, wavlm = load_wavlm_checkpoint(cfg.wavlm_path, device=device, dtype=dtype)
    sd = read_reference_state_dict(model_checkpoint(args.model_path, args.use_ema))
    model = load_reference_mdm(
        sd, resolve_moe_config(mdm_config(cfg, wcfg.encoder_embed_dim, args.serve_fast), sd),
        device=device)

    noise_schedule = cfg.get("noise_schedule", "cosine")
    if stage is not None:
        # the student's grid indexes its teacher's base schedule, as
        # schedule.json records it, not the serving yaml's
        base_name = stage.get("noise_schedule", noise_schedule)
        if base_steps != cfg.diffusion_steps or base_name != noise_schedule:
            print(f"note: distilled student records a {base_name}-{base_steps} base "
                  f"schedule; using it over the yaml's {noise_schedule}-{cfg.diffusion_steps}")
        sched = D.spaced_schedule(D.named_beta_schedule(base_name, base_steps), grid,
                                  device=device)
    elif args.respace:
        sched = D.spaced_schedule(
            D.named_beta_schedule(noise_schedule, cfg.diffusion_steps),
            D.space_timesteps(cfg.diffusion_steps, f"ddim{args.respace}"), device=device)
    else:
        sched = D.Schedule.create(D.named_beta_schedule(noise_schedule, cfg.diffusion_steps),
                                  device=device)

    audio = load_wav_16k(args.audiowavlm_path)
    if args.normalize_loudness:
        audio = normalize_loudness(audio, 16000.0)
    if args.max_len:
        audio = audio[: int(args.max_len * 16000 // cfg.motion_resampling_framerate)]

    if args.styles:
        specs = args.styles.split(";" if ";" in args.styles else ",")
        style = np.stack([parse_style(t) for t in specs])
        tokens = [_sanitize(t) for t in specs]
    else:
        token = args.style
        if not token:
            parts = os.path.basename(args.audiowavlm_path).split("_")
            if len(parts) < 2:
                raise SystemExit(
                    f"cannot infer a style from {os.path.basename(args.audiowavlm_path)!r} "
                    "(expected NNN_Style_... naming) — pass --style")
            token = parts[1]
        style = parse_style(token)[None]
        tokens = [_sanitize(token)]

    mean = np.load(os.path.join(cfg.data_dir, "mean.npz"))["mean"]
    std = np.load(os.path.join(cfg.data_dir, "std.npz"))["std"]

    def model_apply(mdm, x, t, cond, uncond=None):
        return mdm(x, t, cond, uncond=uncond)

    sampler = ZeggsSampler(
        model_apply, make_zeggs_wavlm_fn(cfg.n_poses), sched,
        ZeggsEngineConfig(
            n_poses=cfg.n_poses, n_seed=cfg.n_seed, njoints=cfg.njoints,
            fps=cfg.motion_resampling_framerate, guidance_scale=args.guidance_scale,
            skip_timesteps=args.skip_timesteps, sampler=args.sampler,
            # multi-style batches pin the crossfade width to 1 so each
            # style's BVH equals its own single-style run
            crossfade_n=1 if style.shape[0] > 1 else None),
        device=device)
    buckets = tuple(int(b) for b in args.window_buckets.split(",")) if args.window_buckets else None
    generator = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    out = sampler.generate(model, wavlm, audio, style, generator, mean=mean, std=std,
                           window_buckets=buckets)
    seconds = time.perf_counter() - t0  # `generate` returns host numpy: the device is done
    capture = sampler.capture_seconds
    print(f"generated {out.shape[0]}x{out.shape[1]} frames in {seconds:.3f} s "
          f"({out.shape[0] * out.shape[1] / seconds:.1f} frames/s) on {device}"
          + (f", {capture:.3f} s of it capturing CUDA graphs" if sampler.graphs else ""))

    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    paths = []
    for i, tok in enumerate(tokens):
        out_path = os.path.join(args.save_dir, f"{stamp}_{tok}_{args.seed}.bvh")
        zf.pose_features_to_bvh(out[i], out_path, smoothing=True)
        print("wrote", out_path)
        paths.append(out_path)
    return {"paths": paths, "poses": out, "generate_seconds": seconds,
            "capture_seconds": capture}


if __name__ == "__main__":
    main()
