"""Sampling CLI: 16 kHz wav → ZEGGS gestures → .bvh, on the card by default.

Usage (mirrors `main/mydiffusion_zeggs/sample.py:400-420` and the JAX
package's `cli/sample.py`):
  python -m diffusestylegesture_torch.cli.sample --config configs/zeggs.yml \\
      --model_path model000450000.pt --audiowavlm_path 015_Happy_4_x_1_0.wav \\
      --max_len 320

`--model_path` is a reference-layout MDM `.pt`; the WavLM checkpoint is
the yaml's `wavlm_path`. The quality gate is checked before any model is
loaded. Not ported yet: orbax checkpoints and distilled-student stage
dirs, --use_ema, --serve_fast, --normalize_loudness, --aot_dir.
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np
import torch

from .. import diffusion as D
from ..config import load_yaml_config
from ..data import load_wav_16k
from ..device import resolve_device
from ..models.convert import load_reference_mdm, load_wavlm_checkpoint
from ..models.mdm import MDMConfig
from ..models.wavlm import make_zeggs_wavlm_fn
from ..motion import zeggs_features as zf
from ..sample import ZeggsEngineConfig, ZeggsSampler
from ..sample.quality_gate import check_mode
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
    p.add_argument("--model_path", required=True, help="reference-layout MDM .pt")
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
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "plms", "dpmpp"])
    p.add_argument("--respace", type=int, default=0,
                   help="respace the schedule to N timesteps (ddimN striding)")
    p.add_argument("--allow_degraded", action="store_true",
                   help="serve a mode the quality gate measured as degraded")
    p.add_argument("--window_buckets", default=None,
                   help="comma-separated window-count buckets for the encoder batch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    """Returns {'paths': [written .bvh], 'poses': (B, T, njoints) array,
    'generate_seconds': wall time of the engine call}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config)

    status, message = check_mode(args.sampler, args.respace, cfg.diffusion_steps)
    if status == "degraded" and not args.allow_degraded:
        raise SystemExit(f"REFUSED: {message}")
    if status != "baseline":
        print(("note: " if status == "unknown" else "") + message)

    os.makedirs(args.save_dir, exist_ok=True)
    wcfg, wavlm = load_wavlm_checkpoint(cfg.wavlm_path, device=device)
    mcfg = MDMConfig(
        njoints=cfg.njoints, latent_dim=cfg.latent_dim, ff_size=cfg.get("ff_size", 1024),
        num_layers=cfg.get("num_layers", 8), num_heads=cfg.get("num_heads", 4),
        n_seed=cfg.n_seed, cond_mode=cfg.cond_mode, cond_mask_prob=cfg.cond_mask_prob,
        audio_feat=cfg.audio_feat, audio_in_dim=wcfg.encoder_embed_dim,
        moe_experts=cfg.get("moe_experts", 0))
    model = load_reference_mdm(args.model_path, mcfg, device=device)

    betas = D.named_beta_schedule(cfg.get("noise_schedule", "cosine"), cfg.diffusion_steps)
    if args.respace:
        sched = D.spaced_schedule(
            betas, D.space_timesteps(cfg.diffusion_steps, f"ddim{args.respace}"), device=device)
    else:
        sched = D.Schedule.create(betas, device=device)

    audio = load_wav_16k(args.audiowavlm_path)
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
    print(f"generated {out.shape[0]}x{out.shape[1]} frames in {seconds:.3f} s "
          f"({out.shape[0] * out.shape[1] / seconds:.1f} frames/s) on {device}")

    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    paths = []
    for i, tok in enumerate(tokens):
        out_path = os.path.join(args.save_dir, f"{stamp}_{tok}_{args.seed}.bvh")
        zf.pose_features_to_bvh(out[i], out_path, smoothing=True)
        print("wrote", out_path)
        paths.append(out_path)
    return {"paths": paths, "poses": out, "generate_seconds": seconds}


if __name__ == "__main__":
    main()
