"""Training CLI, on the card by default.

  python -m diffusestylegesture_torch.cli.train --config configs/zeggs.yml \\
      [--bf16] [--device_cache] [--num_steps N] [--batch_size B]
  python -m diffusestylegesture_torch.cli.train --config configs/beat_twh.yml \\
      --dataset TWH --name DiffuseStyleGesture+ [--bf16] [--device_cache]

Port of `diffusestylegesture_tpu/cli/train.py` (reference
`main/mydiffusion_zeggs/end2end.py:19-71`,
`BEAT-TWH-main/mydiffusion_beat_twh/end2end.py:19-101`):

* ZEGGS: the yaml's `data_dir` holds the output of `cli/prepare_data.py`; the
  windows come from `<data_dir>/train` with WavLM-Large features computed from
  the yaml's `wavlm_path` (or, when that file is missing, from the dataset's
  feature cache; with neither the run stops).
* BEAT / TWH: the yaml's `h5file` is the dataset store `cli/prepare_data.py`
  wrote (the port's `.npz`; a JAX-written `.h5` needs h5py); the fields that
  depend on the dataset and the model name (DiffuseStyleGesture / + / ++) are
  derived as in the reference, the gesture statistics come from the store,
  and batches are random `n_poses`-frame crops of its clips.

Checkpoints go to `<save_dir>/<step>/`, a directory that `cli/sample.py`
(ZEGGS) or `cli/sample_beat.py` (BEAT/TWH) `--model_path` serves; a run whose
`save_dir` holds one resumes from the latest. `--save_dir` and
`--log_interval` override the yaml's values. The model trains through its
plain PyTorch ops (the CUDA kernels have no backward).

`--bf16` runs the forward under bf16 autocast with float32 master weights,
moments and EMA; `--device_cache` keeps the whole dataset on the card and
gathers each batch there, one captured CUDA graph a step. The mesh and
model-parallel flags of the JAX CLI raise: they come with later slices of the
port.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .. import diffusion as D
from ..config import apply_beat_twh_derivations, load_yaml_config
from ..device import resolve_device
from ..models.mdm import MDM, MDMConfig
from ..models.mdm_plus import MDMPlus
from ..train import (LoopConfig, TrainConfig, TrainLoop, make_beat_cond_builder,
                     make_zeggs_cond_builder)

LATER = {"use_mesh": 9, "tp": 9, "fsdp": 9, "pp": 9, "sp": 9, "split_qkv": 9, "moe_experts": 8}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DiffuseStyleGesture training (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--dataset", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--save_dir", default=None, help="checkpoint directory (default: the yaml's)")
    p.add_argument("--log_interval", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device_cache", action="store_true",
                   help="keep the window set on the card and gather each batch there")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 autocast forward, float32 master weights / moments / EMA")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for flag in ("use_mesh", "fsdp", "split_qkv"):
        p.add_argument(f"--{flag}", action="store_true", help=argparse.SUPPRESS)
    for flag in ("tp", "pp", "sp", "moe_experts"):
        p.add_argument(f"--{flag}", type=int, default=None, help=argparse.SUPPRESS)
    return p


def build_zeggs(cfg, device: torch.device, seed: int):
    """(model, dataset, seconds spent computing WavLM features)."""
    from ..data import ZeggsWindowDataset

    wavlm_fn, wavlm_s = None, [0.0]
    if os.path.exists(cfg.wavlm_path):
        from ..models.convert import load_wavlm_checkpoint
        from ..models.wavlm import make_zeggs_wavlm_fn

        _, wavlm = load_wavlm_checkpoint(cfg.wavlm_path, device=device)
        feats = make_zeggs_wavlm_fn(cfg.n_poses)

        def wavlm_fn(windows: np.ndarray) -> np.ndarray:
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = feats(wavlm, torch.as_tensor(windows, device=device)).float().cpu().numpy()
            wavlm_s[0] += time.perf_counter() - t0
            return out
    else:
        print(f"WavLM checkpoint {cfg.wavlm_path} not found; using the dataset's cached features")

    data = ZeggsWindowDataset(os.path.join(cfg.data_dir, "train"), wavlm_fn, n_poses=cfg.n_poses,
                              stride=cfg.subdivision_stride, fps=cfg.motion_resampling_framerate)
    mcfg = MDMConfig(
        njoints=cfg.njoints, latent_dim=cfg.latent_dim, ff_size=cfg.get("ff_size", 1024),
        num_layers=cfg.get("num_layers", 8), num_heads=cfg.get("num_heads", 4),
        n_seed=cfg.n_seed, cond_mode=cfg.cond_mode, cond_mask_prob=cfg.cond_mask_prob,
        audio_feat=cfg.audio_feat, audio_in_dim=data.wavlm.shape[-1],
        # training runs the plain PyTorch ops with autograd, the counterpart of the
        # JAX trainer's XLA path (MDM attn_impl="xla", the flax trunk): the CUDA
        # kernels, like the Pallas kernels they port, have no backward
        impl="plain")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MDM(mcfg)
    return model.to(device), data, wavlm_s[0]


def build_beat_twh(cfg, device: torch.device, seed: int):
    """(model, dataset, cond builder) for a derived BEAT/TWH yaml: the
    `cli/sample_beat.py` denoiser config on the plain route (training needs
    autograd, which the CUDA kernels lack), the store's gesture statistics
    and its clips."""
    from ..data import SpeechGestureDataset, gesture_statistics
    from .sample_beat import mdm_plus_config

    mean, std = gesture_statistics(cfg.h5file)
    data = SpeechGestureDataset(cfg.h5file, mean, std, n_poses=cfg.n_poses)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MDMPlus(dataclasses.replace(mdm_plus_config(cfg), impl="plain"))
    return model.to(device), data, make_beat_cond_builder(cfg.cond_mode, cfg.n_seed)


def main(argv=None):
    """Returns {'loop': the TrainLoop, 'state', 'dataset', 'prepare_s' (dataset
    and features), 'wavlm_s' (the WavLM part of it), 'save_dir'}."""
    args = build_parser().parse_args(argv)
    for flag, slice_no in LATER.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} comes with slice {slice_no} of the port; use "
                                      "diffusestylegesture_tpu.cli.train until then")
    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config, {k: getattr(args, k) for k in (
        "dataset", "name", "num_steps", "batch_size", "save_dir", "log_interval")})
    if cfg.get("moe_experts", 0):
        raise NotImplementedError("MoE training comes with slice 8 of the port")

    t0 = time.perf_counter()
    if cfg.dataset == "ZEGGS":
        model, dataset, wavlm_s = build_zeggs(cfg, device, args.seed)
        builder = make_zeggs_cond_builder(cfg.n_seed)
        print(f"{len(dataset)} training windows ready in {time.perf_counter() - t0:.1f} s "
              f"({wavlm_s:.1f} s of WavLM features)")
    else:
        cfg = apply_beat_twh_derivations(cfg)
        model, dataset, builder = build_beat_twh(cfg, device, args.seed)
        wavlm_s = 0.0
        print(f"{len(dataset)} {cfg.dataset} clips ({sum(len(g) for g in dataset.gesture)} "
              f"frames) ready in {time.perf_counter() - t0:.1f} s; {cfg.name}, {cfg.cond_mode}")
    prepare_s = time.perf_counter() - t0
    device_cache = None
    if args.device_cache:
        from ..data.device_cache import DeviceWindowCache

        device_cache = (DeviceWindowCache.from_zeggs(dataset, device) if cfg.dataset == "ZEGGS"
                        else DeviceWindowCache.from_beat_twh(dataset, device))
    sched = D.Schedule.create(D.named_beta_schedule(cfg.get("noise_schedule", "cosine"),
                                                    cfg.diffusion_steps), device=device)
    loop = TrainLoop(
        model, sched, None if device_cache is not None else dataset.batches(cfg.batch_size),
        train_cfg=TrainConfig(
            lr=cfg.lr, weight_decay=cfg.get("weight_decay", 0.0),
            lr_anneal_steps=cfg.get("lr_anneal_steps", 0),
            schedule_sampler=cfg.get("schedule_sampler", "uniform"),
            compute_dtype="bfloat16" if args.bf16 else cfg.get("compute_dtype", "float32")),
        loop_cfg=LoopConfig(
            num_steps=cfg.get("num_steps", 100_000), log_interval=cfg.get("log_interval", 50),
            save_interval=cfg.get("save_interval", 50_000), checkpoint_dir=cfg.get("save_dir"),
            log_dir=cfg.get("log_dir"), log_formats=tuple(cfg.get("log_formats", ("stdout",)))),
        cond_builder=builder, seed=args.seed, device_cache=device_cache,
        batch_size=cfg.batch_size)
    state = loop.run()
    return {"loop": loop, "state": state, "dataset": dataset, "prepare_s": prepare_s,
            "wavlm_s": wavlm_s, "save_dir": cfg.get("save_dir")}


if __name__ == "__main__":
    main()
