"""Progressive-distillation CLI (ZEGGS), on the card by default: halve the
sampling chain, stage by stage.

  python -m diffusestylegesture_torch.cli.distill --config configs/zeggs.yml \\
      --teacher checkpoints/zeggs/500000 --stages 3 --steps_per_stage 10000 \\
      --save_dir checkpoints/distilled

Port of `diffusestylegesture_tpu/cli/distill.py`, with its flags and
`--device`. Stage k trains a student whose DDIM grid has half the teacher's
steps (1000 → 500 → 250 …) on the prepared ZEGGS windows, which stay on the
card (`DeviceWindowCache`); each stage's student becomes the next teacher.
`--teacher` is a checkpoint of the port: a `.pt` in reference layout, a
directory holding `model.pt` (a `cli/train.py` step, a converted checkpoint,
a stage dir), or a `cli/train.py` save dir (its latest step). The teacher runs
through the CUDA kernels under `no_grad`, the student through the plain ops
with autograd (`train/distill.py`). On a card `--chunk` steps are one captured
step (`utils/graphs.py::CapturedStep`) replayed `--chunk` times, the
counterpart of the JAX CLI's `lax.scan` chunk, and the loss is read once per
chunk. Each stage writes `<save_dir>/stage{k}_steps{N}/` with `model.pt` and
a `schedule.json` holding the student's grid, which `cli/sample.py
--model_path` serves on that exact DDIM grid.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from .. import diffusion as D
from ..config import load_yaml_config
from ..data import ZeggsWindowDataset
from ..data.device_cache import DeviceWindowCache
from ..device import resolve_device
from ..models.convert import load_reference_mdm, read_reference_state_dict
from ..models.mdm import MDMConfig
from ..train import TrainConfig, TrainState, make_zeggs_cond_builder
from ..train.distill import make_distill_step, student_schedule
from ..utils.graphs import CapturedStep
from .sample import resolve_moe_config


def load_distilled(stage_dir: str, device="cuda"):
    """A distillation stage → (state_dict, spaced Schedule on `device`).

    Serve the schedule with the DDIM sampler: its `timestep_map` remaps the
    shrunken grid onto the original timesteps the student was trained with."""
    with open(os.path.join(stage_dir, "schedule.json")) as f:
        meta = json.load(f)
    sd = torch.load(os.path.join(stage_dir, "model.pt"), map_location="cpu", weights_only=True)
    betas = D.named_beta_schedule(meta["noise_schedule"], meta["base_steps"])
    return sd, D.spaced_schedule(betas, set(meta["use_timesteps"]), device=device)


def teacher_checkpoint(path: str) -> str:
    """The teacher's `.pt`: `path` itself, `<path>/model.pt`, or the latest
    step's `model.pt` of a `cli/train.py` save dir."""
    if not os.path.isdir(path):
        return path
    if os.path.exists(os.path.join(path, "model.pt")):
        return os.path.join(path, "model.pt")
    steps = sorted(int(d) for d in os.listdir(path)
                   if d.isdigit() and os.path.exists(os.path.join(path, d, "model.pt")))
    if not steps:
        raise SystemExit(f"{path} holds no model.pt and no cli/train.py checkpoint")
    return os.path.join(path, str(steps[-1]), "model.pt")


def make_stage_step(student, teacher, sched_teacher, cache: DeviceWindowCache, builder,
                    batch_size: int, lr: float, generator: torch.Generator):
    """(the student's TrainState, step()): one distillation step of a stage, a
    batch gathered on the device from `generator` and then the step's own
    draws, as the JAX chunk body draws its batch and then t and the noise."""
    state = TrainState(student, TrainConfig(lr=lr))  # optax.adam(lr): no decay, no anneal
    distill = make_distill_step(teacher, sched_teacher)

    def step():
        x0, cond, _ = builder(DeviceWindowCache.sample_batch(cache.arrays, generator, batch_size))
        return distill(state, x0, cond, generator)

    return state, step


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="progressive distillation (ZEGGS, PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--teacher", required=True,
                   help="a .pt, a directory holding model.pt, or a cli/train.py save dir")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--stages", type=int, default=1)
    p.add_argument("--steps_per_stage", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=100,
                   help="optimizer steps per replayed CUDA graph; the loss is read once a chunk")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    """Returns {'stages': [{'dir', 'steps', 'losses' (one a chunk), 'boundaries'
    [(step, host seconds) after each chunk's loss read, from the stage's
    start], 'capture_seconds'}]}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config)
    os.makedirs(args.save_dir, exist_ok=True)
    batch_size = args.batch_size or cfg.batch_size
    try:
        data = ZeggsWindowDataset(os.path.join(cfg.data_dir, "train"), None, n_poses=cfg.n_poses,
                                  stride=cfg.subdivision_stride,
                                  fps=cfg.motion_resampling_framerate)
    except ValueError:
        raise SystemExit("distillation needs cached WavLM features in the window cache (run "
                         "training once with a wavlm checkpoint, or prepare-data)") from None

    mcfg = MDMConfig(
        njoints=cfg.njoints, latent_dim=cfg.latent_dim, ff_size=cfg.get("ff_size", 1024),
        num_layers=cfg.get("num_layers", 8), num_heads=cfg.get("num_heads", 4),
        n_seed=cfg.n_seed, cond_mode=cfg.cond_mode, cond_mask_prob=cfg.cond_mask_prob,
        audio_feat=cfg.audio_feat, audio_in_dim=data.wavlm.shape[-1],
        moe_experts=cfg.get("moe_experts", 0), impl="kernel")
    sd = read_reference_state_dict(teacher_checkpoint(args.teacher))
    mcfg = resolve_moe_config(mcfg, sd)
    teacher = load_reference_mdm(sd, mcfg, device=device)
    # the student starts from the teacher's weights and trains through the plain ops
    student = load_reference_mdm(sd, dataclasses.replace(mcfg, impl="plain"), device=device)
    builder = make_zeggs_cond_builder(cfg.n_seed)
    noise_schedule = cfg.get("noise_schedule", "cosine")
    base_betas = D.named_beta_schedule(noise_schedule, cfg.diffusion_steps)
    sched_teacher = D.Schedule.create(base_betas, device=device)
    cache = DeviceWindowCache.from_zeggs(data, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    stages = []
    for stage in range(args.stages):
        nt = sched_teacher.num_timesteps
        print(f"stage {stage}: {nt} → {nt // 2} steps")
        state, step = make_stage_step(student, teacher, sched_teacher, cache, builder,
                                      batch_size, args.lr, generator)
        run = CapturedStep(step, device, [generator])
        chunk = max(min(args.chunk, args.steps_per_stage), 1)
        n_chunks = -(-args.steps_per_stage // chunk) if args.steps_per_stage else 0
        losses, boundaries, t0 = [], [], time.perf_counter()
        for i in range(n_chunks):
            losses.append(float(run(chunk)["loss"]))  # one read a chunk: waits for the card
            boundaries.append(((i + 1) * chunk, time.perf_counter() - t0))
            if i % max(1, n_chunks // 10) == 0:
                print(f"  step {i * chunk}: loss {losses[-1]:.5f}")

        sched_student = student_schedule(sched_teacher, base_betas=base_betas)
        stage_dir = os.path.abspath(os.path.join(args.save_dir, f"stage{stage}_steps{nt // 2}"))
        os.makedirs(stage_dir, exist_ok=True)
        torch.save({k: v.detach().cpu().clone() for k, v in student.state_dict().items()},
                   os.path.join(stage_dir, "model.pt"))
        with open(os.path.join(stage_dir, "schedule.json"), "w") as f:
            json.dump({"base_steps": int(cfg.diffusion_steps), "noise_schedule": noise_schedule,
                       "use_timesteps": sched_student.timestep_map.cpu().numpy().tolist()}, f)
        print("  wrote", stage_dir)
        stages.append({"dir": stage_dir, "steps": n_chunks * chunk, "losses": losses,
                       "boundaries": boundaries,
                       "capture_seconds": run.capture_seconds})

        teacher.load_state_dict(student.state_dict())  # the student teaches the next stage
        sched_teacher = sched_student
        del run, state, step
    return {"stages": stages}


if __name__ == "__main__":
    main()
