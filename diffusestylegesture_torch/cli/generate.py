"""Text-to-motion generation CLI (MDM-legacy product path), on the card by default.

Port of `diffusestylegesture_tpu/cli/generate.py` (reference
`main/sample/generate.py:22-216`): text prompts (--text_prompt /
--input_text) -> the frozen CLIP text encoder -> classifier-free-guided
sampling over the `TextMDM` denoiser -> inverse z-normalisation ->
`recover_from_ric` joint positions -> `results.npy` ({'motion' (N, J, 3, T),
'text', 'lengths', 'num_samples', 'num_repetitions'}) + `results.txt`
(`generate.py:139-175`), and with --save_feats the de-normalised hml_vec
features (`results_feats.npy`) that the T2M evaluators embed.

Every repetition runs in one batch, and CFG runs the cond and uncond passes as
one doubled batch (`diffusion/sampling.py::make_cfg_model_fn`), so one
denoiser call is 2 x repetitions x prompts rows. The loop (ddpm / ddim /
plms / dpmpp, --respace) is the port's `SampleProgram`; on the card each of
its step functions is captured once as a CUDA graph and replayed
(`utils/graphs.py::GraphSet`), and the trunk's 8 layers run kernel B, whose
key-tiled attention grid takes the full 9.8 s (T = 197 with the token).
`sample_t2m(..., graphs=False)` runs the same functions eagerly (the
comparison path, bitwise equal).

`--model_path` is a `cli/train_t2m.py` save dir (`t2m_config.json` + step
dirs of `model.pt` [`model_ema.pt`]); a JAX save dir serves once
`scripts/convert_orbax_to_torch.py` has turned it into one.

Usage:
  python -m diffusestylegesture_torch.cli.generate --model_path save/t2m \\
      --text_prompt "a person walks forward" [--motion_length 6.0 \\
      --guidance_param 2.5 --num_repetitions 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import diffusion as D
from ..device import resolve_device
from ..diffusion.sampling import PROGRAMS, SamplerConfig, make_cfg_model_fn
from ..models.clip_text import caption_encoder_from_spec
from ..models.mdm_text import TextMDM, TextMDMConfig
from ..motion.humanml import recover_from_ric
from ..utils.graphs import GraphSet

# timings of the last `main` call: capture and sampling seconds
LAST_RUN: Dict[str, float] = {}


def step_dirs(model_path: str):
    return sorted(int(d) for d in os.listdir(model_path)
                  if d.isdigit() and os.path.exists(os.path.join(model_path, d, "model.pt")))


def load_t2m_model(model_path: str, device, use_ema: bool = False, impl: str = "kernel",
                   dtype: torch.dtype = torch.float32):
    """(t2m_config dict, TextMDM on `device` in eval mode) from a save dir's
    latest step."""
    with open(os.path.join(model_path, "t2m_config.json")) as f:
        cfg = json.load(f)
    steps = step_dirs(model_path)
    if not steps:
        raise SystemExit(f"{model_path} holds no <step>/model.pt: train with cli.train_t2m, or "
                         "convert a JAX save dir with scripts/convert_orbax_to_torch.py")
    d = os.path.join(model_path, str(steps[-1]))
    path = os.path.join(d, "model_ema.pt")
    if not (use_ema and os.path.exists(path)):
        if use_ema:
            print("note: --use_ema: the checkpoint holds no EMA params; using its params")
        path = os.path.join(d, "model.pt")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    mcfg = TextMDMConfig(njoints=cfg["njoints"], latent_dim=cfg["latent_dim"],
                         ff_size=cfg["ff_size"], num_layers=cfg["num_layers"],
                         clip_dim=int(cfg["clip"]["projection_dim"]),
                         cond_mask_prob=cfg["cond_mask_prob"], impl=impl, dtype=dtype)
    model = TextMDM(mcfg)
    model.load_state_dict(sd)
    return cfg, model.to(device).eval()


def make_schedule(cfg: dict, respace: int, device) -> D.Schedule:
    betas = D.named_beta_schedule(cfg["noise_schedule"], cfg["diffusion_steps"])
    if respace:
        return D.spaced_schedule(betas, D.space_timesteps(cfg["diffusion_steps"],
                                                          f"ddim{respace}"), device=device)
    return D.Schedule.create(betas, device=device)


def sample_t2m(model: TextMDM, sched: D.Schedule, text_emb: torch.Tensor, n_frames: int, *,
               sampler: str = "ddpm", guidance: float = 2.5, seed: int = 10,
               graphs: Optional[bool] = None, noise: Optional[torch.Tensor] = None):
    """(B, njoints, 1, n_frames) samples for the (B, clip_dim) text embeddings,
    and the seconds spent capturing graphs. graphs: None = on a CUDA device."""
    dev = text_emb.device
    graphs = dev.type == "cuda" if graphs is None else graphs
    B = text_emb.shape[0]
    cond = {"text_emb": text_emb}

    def model_apply(_params, x, t, c, uncond=None):
        return model(x, t, c, uncond=uncond)

    if guidance != 1.0:
        model_fn = make_cfg_model_fn(model_apply, guidance, B, params=None, cond=cond)
    else:
        def model_fn(x, t):
            return model(x, t, cond)

    generator = torch.Generator(device=dev).manual_seed(seed)
    prog = PROGRAMS[sampler](sched, model_fn, (B, model.cfg.njoints, 1, n_frames), generator,
                             cfg=SamplerConfig())
    capture_s = 0.0
    with torch.no_grad():
        if graphs:
            graph_set, captured, step = GraphSet(dev, [generator]), [], prog.t0
            state = generator.get_state()
            for phase in prog.phases:
                graph, _ = graph_set.capture(phase.fn,
                                             prepare=lambda s=step: prog.idx.fill_(s))
                captured.append(graph)
                step -= phase.count
            generator.set_state(state)  # the warm-up calls' draws go back
            capture_s = graph_set.capture_seconds
            prog.init(noise)
            for phase, graph in zip(prog.phases, captured):
                graph.replay(phase.count)
        else:
            prog.init(noise)
            prog.run()
    return prog.img.clone(), capture_s


def main(argv=None):
    p = argparse.ArgumentParser(description="MDM text-to-motion generation")
    p.add_argument("--model_path", required=True,
                   help="train_t2m save dir (t2m_config.json + <step>/model.pt)")
    p.add_argument("--output_dir", default="")
    p.add_argument("--text_prompt", default="")
    p.add_argument("--input_text", default="", help="file with one prompt per line")
    p.add_argument("--num_samples", type=int, default=10,
                   help="prompts are required (the reference's dataset-driven default "
                        "needs the HumanML3D test split)")
    p.add_argument("--num_repetitions", type=int, default=3)
    p.add_argument("--motion_length", type=float, default=6.0,
                   help="seconds (capped at num_frames / fps, the reference's 9.8 s)")
    p.add_argument("--guidance_param", type=float, default=2.5)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "plms", "dpmpp"])
    p.add_argument("--respace", type=int, default=0)
    p.add_argument("--save_feats", action="store_true",
                   help="also write the de-normalised hml_vec features (results_feats.npy)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.text_prompt:
        texts = [args.text_prompt]
    elif args.input_text:
        with open(args.input_text) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
    else:
        raise SystemExit("pass --text_prompt or --input_text")
    num_samples = len(texts)

    with open(os.path.join(args.model_path, "t2m_config.json")) as f:
        clip_spec = json.load(f)["clip"]
    encode, _ = caption_encoder_from_spec(clip_spec, args.model_path, device)
    text_emb = encode(texts)  # (num_samples, clip_dim)
    cfg, model = load_t2m_model(args.model_path, device, args.use_ema)
    n_frames = min(int(cfg["num_frames"]), int(args.motion_length * float(cfg["fps"])))
    sched = make_schedule(cfg, args.respace, device)

    # rows rep-major, as the reference's loop over repetitions orders them
    B = args.num_repetitions * num_samples
    emb = torch.from_numpy(np.tile(text_emb, (args.num_repetitions, 1))).to(device)
    t0 = time.perf_counter()
    sample, capture_s = sample_t2m(model, sched, emb, n_frames, sampler=args.sampler,
                                   guidance=args.guidance_param, seed=args.seed)
    feats = sample[:, :, 0, :].transpose(1, 2).cpu().numpy()  # (B, T, C)
    LAST_RUN.clear()
    LAST_RUN.update(seconds=time.perf_counter() - t0, capture_seconds=capture_s)

    mean, std = np.load(cfg["mean"]), np.load(cfg["std"])
    feats = feats * std + mean
    joints_num = 22 if cfg["dataset"] == "humanml" else 21
    xyz = recover_from_ric(torch.as_tensor(feats, dtype=torch.float32), joints_num).numpy()
    motion = xyz.transpose(0, 2, 3, 1)  # (N, joints, 3, T), `generate.py:139-147`

    out_path = args.output_dir or os.path.join(
        args.model_path, f"samples_seed{args.seed}" + (
            "_" + args.text_prompt.replace(" ", "_").replace(".", "")
            if args.text_prompt else ""))
    os.makedirs(out_path, exist_ok=True)
    all_text = texts * args.num_repetitions
    np.save(os.path.join(out_path, "results.npy"),
            {"motion": motion, "text": all_text, "lengths": np.full((B,), n_frames, np.int64),
             "num_samples": num_samples, "num_repetitions": args.num_repetitions})
    if args.save_feats:
        np.save(os.path.join(out_path, "results_feats.npy"), feats)
    with open(os.path.join(out_path, "results.txt"), "w") as f:
        f.write("\n".join(all_text))
    print("wrote", os.path.join(out_path, "results.npy"), f"motion {motion.shape}",
          f"({LAST_RUN['seconds']:.2f} s, capture {capture_s:.2f} s)")
    return out_path


if __name__ == "__main__":
    main()
