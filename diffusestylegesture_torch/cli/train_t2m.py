"""Text-to-motion training CLI (MDM-legacy product path), on the card by default.

Port of `diffusestylegesture_tpu/cli/train_t2m.py` (reference
`main/train/train_mdm.py`, `main/utils/parser_util.py` defaults): HumanML3D /
KIT `Text2MotionDataset` clips + CLIP text conditioning -> `TextMDM` ->
the port's train step and loop (cosine-1000, predict x0, the loss masked to
each clip's real frames), training through the plain trunk (kernel B has no
backward).

Each distinct caption is encoded once by the frozen text encoder (the corpus
is static). The encoder is not part of the denoiser checkpoint (as
`load_model_wo_clip`); `<save_dir>/t2m_config.json` records its spec, which
`cli/generate.py` reads. Unlike the JAX CLI, whose seed-only spec names a
`jax.random.PRNGKey(seed)` init, the port writes the encoder's weights to
`<save_dir>/clip_text.pt` and names that file in the spec. Checkpoints go to
`<save_dir>/<step>/{model.pt, model_ema.pt, train_state.pt}`: the port keeps
an EMA of the weights at rate `EMA_RATE`, which `generate --use_ema` serves
(the JAX CLI keeps none).

Usage:
  python -m diffusestylegesture_torch.cli.train_t2m \\
      --motion_dir .../new_joint_vecs --text_dir .../texts \\
      --split .../train.txt --mean .../Mean.npy --std .../Std.npy \\
      --save_dir ./save/t2m [--clip_params clip.pt|clip.npz --tokenizer_dir ...] \\
      [--bf16] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import diffusion as D
from ..data.humanml import T2MConfig, Text2MotionDataset
from ..device import resolve_device
from ..models.clip_text import make_caption_encoder
from ..models.mdm_text import TextMDM, TextMDMConfig, make_t2m_cond_builder
from ..train.loop import LoopConfig, TrainLoop
from ..train.state import TrainConfig

CLIP_FILE = "clip_text.pt"
EMA_RATE = 0.9999


def main(argv=None):
    """Returns {'loop': the TrainLoop, 'state', 'dataset', 'save_dir', 'encode_s'}."""
    p = argparse.ArgumentParser(description="MDM text-to-motion training")
    p.add_argument("--motion_dir", required=True)
    p.add_argument("--text_dir", required=True)
    p.add_argument("--split", required=True, help="split id-list file")
    p.add_argument("--mean", required=True)
    p.add_argument("--std", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--dataset", default="humanml", choices=["humanml", "kit"])
    # parser_util.py defaults: latent 512, 8 layers, ff 1024, lr 1e-4, batch 64,
    # cond_mask_prob .1, cosine-1000
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--ff_size", type=int, default=1024)
    p.add_argument("--cond_mask_prob", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=600_000)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", default="cosine")
    p.add_argument("--num_frames", type=int, default=196)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--save_interval", type=int, default=50_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    # the frozen text encoder: converted CLIP weights + a real tokenizer, or a
    # seeded encoder with the hash tokenizer for from-scratch runs
    p.add_argument("--clip_params", default=None)
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--clip_seed", type=int, default=0)
    p.add_argument("--clip_width", type=int, default=512)
    p.add_argument("--clip_layers", type=int, default=12)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    njoints = 263 if args.dataset == "humanml" else 251
    fps = 20 if args.dataset == "humanml" else 12.5
    mean, std = np.load(args.mean), np.load(args.std)
    dcfg = T2MConfig(motion_dir=args.motion_dir, text_dir=args.text_dir,
                     dataset_name="t2m" if args.dataset == "humanml" else "kit",
                     max_motion_length=args.num_frames, fps=int(fps))
    dataset = Text2MotionDataset(dcfg, mean, std, args.split, w_vectorizer=None, seed=args.seed)
    if len(dataset) == 0:
        raise SystemExit("no usable clips under --motion_dir/--text_dir")

    t0 = time.perf_counter()
    encode, clip_spec = make_caption_encoder(
        args.clip_params, seed=args.clip_seed, width=args.clip_width, layers=args.clip_layers,
        tokenizer_dir=args.tokenizer_dir, device=device)
    captions = dataset.captions()
    embs = np.concatenate([encode(captions[i: i + 256]) for i in range(0, len(captions), 256)])
    text_embs = dict(zip(captions, embs))
    encode_s = time.perf_counter() - t0
    print(f"{len(dataset)} clips, {len(captions)} distinct captions encoded")

    os.makedirs(args.save_dir, exist_ok=True)
    if not args.clip_params:  # the seeded encoder: keep its weights for generate
        torch.save(encode.encoder.state_dict(), os.path.join(args.save_dir, CLIP_FILE))
        clip_spec = {**clip_spec, "params_path": CLIP_FILE}

    mcfg = TextMDMConfig(njoints=njoints, latent_dim=args.latent_dim, ff_size=args.ff_size,
                         num_layers=args.num_layers, clip_dim=int(clip_spec["projection_dim"]),
                         cond_mask_prob=args.cond_mask_prob, impl="plain")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = TextMDM(mcfg).to(device)
    sched = D.Schedule.create(D.named_beta_schedule(args.noise_schedule, args.diffusion_steps),
                              device=device)

    with open(os.path.join(args.save_dir, "t2m_config.json"), "w") as f:
        json.dump({
            "dataset": args.dataset, "njoints": njoints, "latent_dim": args.latent_dim,
            "num_layers": args.num_layers, "ff_size": args.ff_size,
            "cond_mask_prob": args.cond_mask_prob, "diffusion_steps": args.diffusion_steps,
            "noise_schedule": args.noise_schedule, "num_frames": args.num_frames, "fps": fps,
            "mean": os.path.abspath(args.mean), "std": os.path.abspath(args.std),
            "clip": clip_spec,
        }, f, indent=1)

    loop = TrainLoop(
        model, sched, dataset.train_batches(args.batch_size, text_embs),
        train_cfg=TrainConfig(lr=args.lr, ema_rate=EMA_RATE,
                              compute_dtype="bfloat16" if args.bf16 else "float32"),
        loop_cfg=LoopConfig(num_steps=args.num_steps, log_interval=args.log_interval,
                            save_interval=args.save_interval, checkpoint_dir=args.save_dir),
        cond_builder=make_t2m_cond_builder(), seed=args.seed)
    state = loop.run()
    return {"loop": loop, "state": state, "dataset": dataset, "save_dir": args.save_dir,
            "encode_s": encode_s}


if __name__ == "__main__":
    main()
