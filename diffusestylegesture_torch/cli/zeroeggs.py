"""ZeroEGGS CLI: prepare / train / generate, on the card by default.

Port of `diffusestylegesture_tpu/cli/zeroeggs.py`, with its flags and
`--device` (`cuda`, or `cpu` on request); the reference ships the RNN system
with its own entry points (`ubisoft-laforge-ZeroEGGS-main/ZEGGS/main.py`,
`generate.py:20-129`):

  prepare   paired wav + bvh dir → features.npz (60 fps animation features
            from the ZEGGS featurizer + log-mel + energy audio features) and
            stats.npz (the `data_pipeline.py` role);
  train     windows over the prepared npz → VAE style encoder + speech
            encoder + autoregressive GRU decoder, RAdam + KL annealing (the
            `train.py:30-770` role); saves config.json + model.pt (the three
            networks' state_dict; `scripts/convert_orbax_to_torch.py` turns a
            JAX save dir into the same);
  generate  wav + style example bvh(s) → stylized BVH with `add` or `stitch`
            blending (the `generate.py` role).

Feature layout (of the 1141-d ZEGGS vector at 60 fps):
  [0:3] root_pos  [3:7] root_rot  [7:10] root_vel  [10:13] root_vrt
  [13:238] lpos  [238:688] ltxy  [688:913] lvel  [913:1138] lvrt
  [1138:1141] gaze_dir
Anim input = vel/vrt + lpos + ltxy + lvel + lvrt + gaze (15J+9 = 1134).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from ..data.zeggs import load_wav_16k
from ..data.zeroeggs_data import audio_features, feature_statistics
from ..device import resolve_device
from ..models.zeroeggs import ZeroEGGS, ZeroEGGSConfig, ZeroEggsTrainStep, stats_to_device
from ..motion import quat, txform
from ..motion import zeggs_features as zf
from ..sample.engine_zeroeggs import ZeroEggsGenerator

J = 75
SLICES = {
    "root_pos": (0, 3),
    "root_rot": (3, 7),
    "root_vel": (7, 10),
    "root_vrt": (10, 13),
    "lpos": (13, 13 + J * 3),
    "ltxy": (13 + J * 3, 13 + J * 9),
    "lvel": (13 + J * 9, 13 + J * 12),
    "lvrt": (13 + J * 12, 13 + J * 15),
    "gaze_dir": (13 + J * 15, 13 + J * 15 + 3),
}


def _sl(feats: np.ndarray, name: str) -> np.ndarray:
    a, b = SLICES[name]
    return feats[..., a:b]


def anim_input_from_features(feats: np.ndarray) -> np.ndarray:
    """(T, 1141) → (T, 1134) style-encoder / anim-input vector."""
    return np.concatenate([_sl(feats, k) for k in ("root_vel", "root_vrt", "lpos", "ltxy", "lvel",
                                                   "lvrt", "gaze_dir")], axis=-1)


def first_pose_state(feats_row: np.ndarray):
    """One feature row → the decoder's 8-tuple initial state."""
    return (_sl(feats_row, "root_pos"), _sl(feats_row, "root_rot"), _sl(feats_row, "root_vel"),
            _sl(feats_row, "root_vrt"), _sl(feats_row, "lpos").reshape(J, 3),
            _sl(feats_row, "ltxy").reshape(J, 2, 3), _sl(feats_row, "lvel").reshape(J, 3),
            _sl(feats_row, "lvrt").reshape(J, 3))


# ---------------------------------------------------------------------------
# prepare
# ---------------------------------------------------------------------------


def cmd_prepare(args) -> dict:
    """Host work only (numpy); returns {'clips', 'seconds'}."""
    t0 = time.perf_counter()
    wavs = sorted(f for f in os.listdir(args.source) if f.endswith(".wav")
                  and os.path.exists(os.path.join(args.source, f[:-4] + ".bvh")))
    if not wavs:
        raise SystemExit(f"no paired wav+bvh in {args.source}")
    os.makedirs(args.target, exist_ok=True)
    all_feats, all_audio, names = [], [], []
    for w in wavs:
        stem = w[:-4]
        feats = zf.featurize_bvh_file(os.path.join(args.source, stem + ".bvh"),
                                      fps=60)["features"].astype(np.float32)
        af = audio_features(load_wav_16k(os.path.join(args.source, w)), 16000, 60.0, len(feats))
        all_feats.append(feats)
        all_audio.append(af)
        names.append(stem)
        print(f"{stem}: {feats.shape[0]} frames")

    stats = feature_statistics({
        "audio_input": np.concatenate(all_audio, 0),
        "anim_input": np.concatenate([anim_input_from_features(f) for f in all_feats], 0)})
    # decoder output = vel/vrt + lpos/ltxy/lvel/lvrt (15J+6)
    anim_out = np.concatenate([np.concatenate(
        [_sl(f, k) for k in ("root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")], axis=-1)
        for f in all_feats], 0)
    stats.update(feature_statistics({"anim_output": anim_out}))
    np.savez(os.path.join(args.target, "features.npz"),
             **{f"feats_{n}": f for n, f in zip(names, all_feats)},
             **{f"audio_{n}": a for n, a in zip(names, all_audio)}, names=np.asarray(names))
    np.savez(os.path.join(args.target, "stats.npz"), **stats)
    print("wrote", os.path.join(args.target, "features.npz"), "and stats.npz")
    return {"clips": len(names), "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def sample_batch(rng: np.random.Generator, feats, audio, W: int, B: int) -> dict:
    """B windows of W+1 frames from random clips (the JAX CLI's draws):
    frame 0 is the initial state, frames 1…W the targets and inputs."""
    usable = [i for i in range(len(feats)) if len(feats[i]) >= W + 1]
    if not usable:  # clips shorter than one window cannot be sampled
        raise SystemExit(f"no prepared clip has >= {W + 1} frames (--window {W})")
    batch_feats, batch_audio = [], []
    for _ in range(B):
        ci = usable[rng.integers(len(usable))]
        s = rng.integers(0, len(feats[ci]) - W)  # the last start T - W - 1 included
        batch_feats.append(feats[ci][s: s + W + 1])
        batch_audio.append(audio[ci][s + 1: s + W + 1])
    f = np.stack(batch_feats)
    tgt = f[:, 1:]
    return dict(
        initial_state=tuple(np.stack(x) for x in zip(*[first_pose_state(ff[0]) for ff in f])),
        gaze=_sl(tgt, "gaze_dir"), audio_features=np.stack(batch_audio),
        anim_input=np.stack([anim_input_from_features(ff[1:]) for ff in f]),
        target_root_pos=_sl(tgt, "root_pos"), target_root_rot=_sl(tgt, "root_rot"),
        target_lpos=_sl(tgt, "lpos").reshape(B, W, J, 3),
        target_ltxy=_sl(tgt, "ltxy").reshape(B, W, J, 2, 3))


def batch_to_device(batch: dict, stats: dict, device) -> dict:
    """Host batch → device tensors; the style example normalized as the
    reference does before its encoder (`train.py:224`), as generation does."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)  # noqa: E731
    out = {k: t(v) for k, v in batch.items() if k not in ("initial_state", "anim_input")}
    out["initial_state"] = tuple(t(a) for a in batch["initial_state"])
    out["style_example"] = (t(batch["anim_input"]) - stats["anim_input_mean"]) / \
        stats["anim_input_std"]
    return out


def cmd_train(args) -> dict:
    """Returns {'losses': per logged step, 'step_seconds': wall time of each
    step (host batch + device step, synchronized)}."""
    device = resolve_device(args.device)
    data = np.load(os.path.join(args.data, "features.npz"), allow_pickle=False)
    stats = stats_to_device(dict(np.load(os.path.join(args.data, "stats.npz"))), device)
    names = [str(n) for n in data["names"]]
    feats = [data[f"feats_{n}"] for n in names]
    audio = [data[f"audio_{n}"] for n in names]
    audio_dim = audio[0].shape[1]
    cfg_dict = dict(hidden_size=args.hidden_size, speech_encoding_size=args.speech_encoding_size,
                    style_embedding_size=args.style_embedding_size,
                    num_rnn_layers=args.num_rnn_layers, style_encoder_type=args.style_encoder)
    torch.manual_seed(args.seed)
    model = ZeroEGGS(ZeroEGGSConfig(**cfg_dict), audio_dim).to(device)
    step = ZeroEggsTrainStep(model, stats, lr=args.lr)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    losses, seconds = [], []
    for i in range(args.num_steps):
        t0 = time.perf_counter()
        aux = step.step(batch_to_device(sample_batch(rng, feats, audio, args.window,
                                                     args.batch_size), stats, device),
                        generator, i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        if i % max(1, args.num_steps // 10) == 0:
            values = {k: float(v) for k, v in aux.items()}
            losses.append(values["loss"])
            print(f"step {i}: loss {values['loss']:.4f} "
                  f"(rec {values['rec']:.4f}, kl {values['kl']:.4f})")
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "config.json"), "w") as f:
        json.dump({**cfg_dict, "audio_dim": audio_dim}, f)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(args.save_dir, "model.pt"))
    print("wrote", args.save_dir)
    return {"losses": losses, "step_seconds": seconds}


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def load_network(network: str, device) -> ZeroEGGS:
    """A train --save_dir (config.json + model.pt) → the model on `device`."""
    with open(os.path.join(network, "config.json")) as f:
        cfg_dict = json.load(f)
    audio_dim = cfg_dict.pop("audio_dim")
    path = os.path.join(network, "model.pt")
    if not os.path.exists(path):
        raise SystemExit(f"{network} holds no model.pt: convert a JAX save dir with "
                         "scripts/convert_orbax_to_torch.py (beside the JAX package) first")
    model = ZeroEGGS(ZeroEGGSConfig(**cfg_dict), audio_dim)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(device).eval()


def cmd_generate(args) -> dict:
    """Returns {'path', 'frames', 'generate_seconds', 'capture_seconds'}."""
    device = resolve_device(args.device)
    stats = dict(np.load(args.stats))
    gen = ZeroEggsGenerator(load_network(args.network, device), stats, device=device)
    # style encodings from bvh examples (path[:start:end]), blended
    generator = torch.Generator(device=device).manual_seed(args.seed)
    encodings = []
    for spec in args.style:
        parts = spec.split(":")
        feats = zf.featurize_bvh_file(parts[0], fps=60)["features"]
        if len(parts) == 3:
            feats = feats[int(parts[1]): int(parts[2])]
        ex = (anim_input_from_features(feats) - stats["anim_input_mean"]) / \
            stats["anim_input_std"]
        encodings.append(gen.encode_style(ex, generator, temperature=args.temperature))

    audio = load_wav_16k(args.audio)
    n_frames = int(round(60.0 * len(audio) / 16000))
    af = audio_features(audio, 16000, 60.0, n_frames)
    fp_feats = zf.featurize_bvh_file(args.first_pose or args.style[0].split(":")[0],
                                     fps=60)["features"]
    ratios = [float(r) for r in args.blend_ratio] if args.blend_ratio else None
    t0 = time.perf_counter()
    root_pos, root_rot, lpos, ltxy = (t[0].cpu().numpy() for t in gen.generate(
        af, encodings, first_pose_state(fp_feats[-1]), blend_type=args.blend,
        blend_ratio=ratios))
    seconds = time.perf_counter() - t0

    lrot = quat.from_xform(txform.orthogonalize_from_xy(ltxy))
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir,
                       datetime.now().strftime("%Y%m%d_%H%M%S") + f"_{args.blend}.bvh")
    zf.write_bvh(out, root_pos, root_rot, lpos, lrot, zf.ZEGGS_PARENTS, zf.ZEGGS_BONE_NAMES,
                 "zyx", 1.0 / 60.0)
    print("wrote", out)
    return {"path": out, "frames": int(root_pos.shape[0]), "generate_seconds": seconds,
            "capture_seconds": gen.capture_seconds}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ZeroEGGS (ported) prepare / train / generate")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("prepare")
    pp.add_argument("--source", required=True)
    pp.add_argument("--target", required=True)

    pt = sub.add_parser("train")
    pt.add_argument("--data", required=True)
    pt.add_argument("--save_dir", required=True)
    pt.add_argument("--num_steps", type=int, default=1000)
    pt.add_argument("--batch_size", type=int, default=8)
    pt.add_argument("--window", type=int, default=60)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--hidden_size", type=int, default=512)
    pt.add_argument("--speech_encoding_size", type=int, default=128)
    pt.add_argument("--style_embedding_size", type=int, default=64)
    pt.add_argument("--num_rnn_layers", type=int, default=2)
    pt.add_argument("--style_encoder", choices=["gru", "attn"], default="gru")
    pt.add_argument("--seed", type=int, default=1234)
    pt.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    pg = sub.add_parser("generate")
    pg.add_argument("--network", required=True, help="train --save_dir")
    pg.add_argument("--stats", required=True, help="prepare target stats.npz")
    pg.add_argument("--audio", required=True)
    pg.add_argument("--style", action="append", required=True,
                    help="example bvh path, optionally path:start:end; repeatable")
    pg.add_argument("--blend", choices=["add", "stitch"], default="add")
    pg.add_argument("--blend_ratio", nargs="*", default=None)
    pg.add_argument("--first_pose", default=None)
    pg.add_argument("--temperature", type=float, default=1.0)
    pg.add_argument("--seed", type=int, default=1234)
    pg.add_argument("--save_dir", default="./zeroeggs_out")
    pg.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"prepare": cmd_prepare, "train": cmd_train, "generate": cmd_generate}[args.cmd](args)


if __name__ == "__main__":
    main()
