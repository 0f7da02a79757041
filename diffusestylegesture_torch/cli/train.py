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
gathers each batch there, one captured CUDA graph a step. `--moe_experts N`
swaps every trunk layer's FFN for a Switch-routed MoE of N experts
(`models/moe.py`) and adds the load-balance loss with weight
`--moe_aux_weight`; it defaults to the yaml's `moe_experts`, and an explicit
0 trains dense from a MoE yaml.

Across cards (JAX `cli/train.py:155-185, 210-220, 278-281`), one process per
card:

  torchrun --nproc_per_node N -m diffusestylegesture_torch.cli.train \
      --config configs/zeggs.yml [--use_mesh] [--fsdp] [--tp K] [--sp K] [--pp K]

builds one `DeviceMesh` of data × [model] × [seq] × [pipe] over the world
(without torchrun the process is a world of one). `--use_mesh`: data
parallelism (the yaml's batch is the global batch); `--fsdp`: ZeRO over
`data`; `--tp K`: Megatron tensor parallelism of the trunk over `model`, in
the split q/k/v layout (`--split_qkv` alone stores that layout); `--sp K`:
the local attention's time axis over `seq` (n_poses must divide into K
shards of whole windows); `--pp K`: the trunk's layers GPipe-pipelined over
`pipe` with `--pipe_microbatches` microbatches (default K). Unlike the JAX
CLI, a degree of 1 given explicitly runs that path on one rank. A degree
that does not divide the ranks left stops the run (SystemExit), as does
`--moe_experts` with `--pp`. Rank 0 logs and saves.
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
    p.add_argument("--moe_experts", type=int, default=None,
                   help="Switch-routed MoE FFN with this many experts in every trunk layer; "
                        "default: the yaml's moe_experts (0 = dense); an explicit 0 forces dense")
    p.add_argument("--moe_aux_weight", type=float, default=0.01,
                   help="weight of the MoE load-balance loss")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--use_mesh", action="store_true",
                   help="data parallelism over every rank (torchrun), the batch being global")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree over the 'model' mesh axis (implies --split_qkv)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO: moments and EMA sharded along 'data', gradients "
                        "reduce-scattered, weights all-gathered")
    p.add_argument("--pp", type=int, default=None,
                   help="pipeline-parallel degree: the trunk's layers over a 'pipe' mesh axis")
    p.add_argument("--pipe_microbatches", type=int, default=0,
                   help="GPipe microbatches a step under --pp (0: the --pp degree)")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel degree: the local attention's time axis over a "
                        "'seq' mesh axis, one-window halo")
    p.add_argument("--split_qkv", action="store_true",
                   help="the trunk's attention in-projection as q / k / v Linears "
                        "(checkpoints stay in the packed layout)")
    return p


def build_mesh(args, device: str):
    """(DeviceMesh of data × [model] × [seq] × [pipe], or None, and the model
    config fields it implies)."""
    from ..parallel import multihost

    degrees = [(name, deg) for deg, name in ((args.tp, "model"), (args.sp, "seq"),
                                             (args.pp, "pipe")) if deg]
    if not (degrees or args.use_mesh or args.fsdp):
        return None, {}
    world = (torch.distributed.get_world_size() if torch.distributed.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    axes, shape = ["data"], [world]
    for name, deg in degrees:
        if deg < 1:
            raise SystemExit(f"{name} degree {deg} must be at least 1")
        if shape[0] % deg:
            raise SystemExit(f"{name} degree {deg} does not divide {shape[0]} remaining ranks")
        axes.append(name)
        shape.append(deg)
        shape[0] //= deg
    multihost.initialize(device)
    mesh = multihost.global_mesh(tuple(axes), tuple(shape))
    extra = {}
    if args.sp:
        extra.update(seq_parallel=True, seq_mesh=mesh)
    if args.pp:
        extra.update(trunk_impl="pipeline", pipe_mesh=mesh,
                     pipe_microbatches=args.pipe_microbatches)
    return mesh, extra


def build_zeggs(cfg, device: torch.device, seed: int, extra=None):
    """(model, dataset, seconds spent computing WavLM features); `extra`:
    more `MDMConfig` fields (the parallel ones)."""
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
        moe_experts=cfg.get("moe_experts", 0), split_qkv=cfg.get("split_qkv", False),
        **(extra or {}),
        # training runs the plain PyTorch ops with autograd, the counterpart of the
        # JAX trainer's XLA path (MDM attn_impl="xla", the flax trunk): the CUDA
        # kernels, like the Pallas kernels they port, have no backward
        impl="plain")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MDM(mcfg)
    return model.to(device), data, wavlm_s[0]


def build_beat_twh(cfg, device: torch.device, seed: int, extra=None):
    """(model, dataset, cond builder) for a derived BEAT/TWH yaml: the
    `cli/sample_beat.py` denoiser config on the plain route (training needs
    autograd, which the CUDA kernels lack) with `extra` fields, the store's
    gesture statistics and its clips."""
    from ..data import SpeechGestureDataset, gesture_statistics
    from .sample_beat import mdm_plus_config

    mean, std = gesture_statistics(cfg.h5file)
    data = SpeechGestureDataset(cfg.h5file, mean, std, n_poses=cfg.n_poses)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MDMPlus(dataclasses.replace(mdm_plus_config(cfg), impl="plain",
                                            split_qkv=cfg.get("split_qkv", False),
                                            **(extra or {})))
    return model.to(device), data, make_beat_cond_builder(cfg.cond_mode, cfg.n_seed)


def main(argv=None):
    """Returns {'loop': the TrainLoop, 'state', 'dataset', 'prepare_s' (dataset
    and features), 'wavlm_s' (the WavLM part of it), 'save_dir', 'mesh'}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config, {k: getattr(args, k) for k in (
        "dataset", "name", "num_steps", "batch_size", "save_dir", "log_interval")})
    if args.moe_experts is None:
        # the yaml's MoE setting, as every serving CLI reads it; the flag, when given, wins
        args.moe_experts = int(cfg.get("moe_experts", 0))
    cfg.moe_experts = args.moe_experts
    if args.moe_experts > 0 and args.pp:
        raise SystemExit("--moe_experts with --pp is unsupported: the pipelined trunk cannot "
                         "carry the MoE load-balance loss")
    if args.split_qkv or args.tp:
        cfg.split_qkv = True  # head-aligned tensor-parallel shards
    mesh, extra = build_mesh(args, args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # cuda:LOCAL_RANK

    t0 = time.perf_counter()
    if cfg.dataset == "ZEGGS":
        model, dataset, wavlm_s = build_zeggs(cfg, device, args.seed, extra)
        builder = make_zeggs_cond_builder(cfg.n_seed)
        print(f"{len(dataset)} training windows ready in {time.perf_counter() - t0:.1f} s "
              f"({wavlm_s:.1f} s of WavLM features)")
    else:
        cfg = apply_beat_twh_derivations(cfg)
        model, dataset, builder = build_beat_twh(cfg, device, args.seed, extra)
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
            compute_dtype="bfloat16" if args.bf16 else cfg.get("compute_dtype", "float32"),
            moe_aux_weight=args.moe_aux_weight if args.moe_experts > 0 else 0.0),
        loop_cfg=LoopConfig(
            num_steps=cfg.get("num_steps", 100_000), log_interval=cfg.get("log_interval", 50),
            save_interval=cfg.get("save_interval", 50_000), checkpoint_dir=cfg.get("save_dir"),
            log_dir=cfg.get("log_dir"), log_formats=tuple(cfg.get("log_formats", ("stdout",))),
            use_mesh=mesh is not None, tensor_parallel=args.tp or 0, fsdp=args.fsdp,
            mesh=mesh),
        cond_builder=builder, seed=args.seed, device_cache=device_cache,
        batch_size=cfg.batch_size)
    state = loop.run()
    return {"loop": loop, "state": state, "dataset": dataset, "prepare_s": prepare_s,
            "wavlm_s": wavlm_s, "save_dir": cfg.get("save_dir"), "mesh": mesh}


if __name__ == "__main__":
    main()
