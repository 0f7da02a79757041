"""Batch-serving CLI: JSONL requests in → stylized BVH files out, on the card by default.

  python -m diffusestylegesture_torch.cli.serve --config configs/zeggs.yml \\
      --model_path model000450000.pt [--requests reqs.jsonl] [--device cpu]

Port of `diffusestylegesture_tpu/cli/serve.py`, with its flags but
`--aot_dir` (a CUDA graph lives in its process; README). Each input line is
a request:
  {"wav": "clip.wav", "style": "Happy", "out": "clip_happy.bvh"}
(`style` is a ZEGGS style token, a blend 'Happy:0.6,Sad:0.4' or a 6-float
list, by default the token in the wav's name; `out` defaults next to the
wav.) Requests are read from `--requests` or stdin and fed through the
micro-batching `GestureServer`, so concurrent lines ride one batched engine
call; one JSON line is printed per request, then the server's counters
(`{"served", "batches", "rows_padded", "windows_encoded", "windows_padding",
"requests_by_bucket"}`: padded rows, windows WavLM encoded and how many of
them carried no request's audio, requests per window-count bucket).
Checkpoints load as in `cli/sample.py` (a reference `.pt` or a converted
directory; a MoE checkpoint with its expert count).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from collections import deque

import numpy as np
import torch

from .. import diffusion as D
from ..config import load_yaml_config
from ..data import load_wav_16k
from ..device import resolve_device
from ..models.convert import (load_reference_mdm, load_wavlm_checkpoint,
                              read_reference_state_dict)
from ..models.wavlm import make_zeggs_wavlm_fn
from ..motion import zeggs_features as zf
from ..sample import GestureServer, ServerConfig, ZeggsEngineConfig, ZeggsSampler
from ..sample.styles import blend_styles
from .sample import mdm_config, model_checkpoint, resolve_moe_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DiffuseStyleGesture serving (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--requests", default=None, help="JSONL file (default stdin)")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_delay_ms", type=float, default=50.0)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--serve_fast", action="store_true",
                   help="bf16 trunk (kernel B's mxu_bf16 mode) + tanh-approx GELU and a bf16 "
                        "WavLM")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--crossfade_n", type=int, default=1,
                   help="crossfade width in overlap frames (default 1 = the reference's "
                        "batch-1 behaviour, independent of the server's batch padding; -1 "
                        "restores the reference quirk where the width follows the batch size)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def parse_style(spec, wav_path: str) -> np.ndarray:
    """A 6-float list, a blend 'Happy:0.6,Sad:0.4', a token, or (None) the
    token of an NNN_Style_... wav name; an unknown token raises ValueError."""
    if isinstance(spec, (list, tuple)):
        return np.asarray(spec, np.float32)
    token = spec or os.path.basename(wav_path).split("_")[1]
    if ":" in token:
        names, weights = zip(*(part.split(":") for part in token.split(",")))
        return blend_styles(names, [float(w) for w in weights])
    onehot = zf.style_onehot(token)
    if onehot is None:
        raise ValueError(f"unknown style token {token!r}")
    return onehot


def build_server(args, device) -> GestureServer:
    """The engine and its server as the CLI runs them (DDPM over the yaml's
    schedule, the JAX CLI's sampler), started."""
    cfg = load_yaml_config(args.config)
    wcfg, wavlm = load_wavlm_checkpoint(
        cfg.wavlm_path, device=device,
        dtype=torch.bfloat16 if args.serve_fast else torch.float32)
    sd = read_reference_state_dict(model_checkpoint(args.model_path, args.use_ema))
    model = load_reference_mdm(
        sd, resolve_moe_config(mdm_config(cfg, wcfg.encoder_embed_dim, args.serve_fast), sd,
                               out=sys.stderr), device=device)
    sched = D.Schedule.create(
        D.named_beta_schedule(cfg.get("noise_schedule", "cosine"), cfg.diffusion_steps),
        device=device)
    sampler = ZeggsSampler(
        lambda mdm, x, t, cond, uncond=None: mdm(x, t, cond, uncond=uncond),
        make_zeggs_wavlm_fn(cfg.n_poses), sched,
        ZeggsEngineConfig(
            n_poses=cfg.n_poses, n_seed=cfg.n_seed, njoints=cfg.njoints,
            fps=cfg.motion_resampling_framerate,
            # batch-size-independent blending: with the reference quirk
            # (crossfade_n=None → n = batch) a request's output would depend on
            # how many requests share its padded batch
            crossfade_n=None if args.crossfade_n < 0 else args.crossfade_n),
        device=device)
    mean = np.load(os.path.join(cfg.data_dir, "mean.npz"))["mean"]
    std = np.load(os.path.join(cfg.data_dir, "std.npz"))["std"]
    return GestureServer(sampler, model, wavlm, mean=mean, std=std,
                         cfg=ServerConfig(max_batch=args.max_batch,
                                          max_delay_ms=args.max_delay_ms),
                         seed=args.seed).start()


def main(argv=None):
    """Serves every request; returns the server's counters (the closing
    line) and 'capture_seconds'.
    Only the server's dispatcher thread touches the card: the reader (this
    thread) and the emitter decode wavs and write BVH files on the host."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    server = build_server(args, device)
    src = open(args.requests) if args.requests else sys.stdin

    pending = deque()
    plock = threading.Condition()
    out_lock = threading.Lock()
    done_reading = [False]
    # back-pressure: without a bound the reader would decode and enqueue a
    # whole large JSONL (10k × 30 s wavs ≈ 10 GB of float32) while the engine
    # drains max_batch at a time
    inflight = threading.Semaphore(max(4 * args.max_batch, 8))

    def say(obj):
        # one result line per request; the emitter and this thread both print
        with out_lock:
            print(json.dumps(obj), flush=True)

    def emit(req, out_path, fut):
        try:
            poses = fut.result()
            zf.pose_features_to_bvh(poses, out_path, smoothing=True)
            say({"wav": req["wav"], "out": out_path, "frames": int(poses.shape[0])})
        except Exception as e:
            say({"wav": req["wav"], "error": str(e)})
        finally:
            inflight.release()

    def emitter():
        # a consumer of its own: results print in submit order the moment each
        # future resolves, independent of the input stream, so an interactive
        # client (write one line, block reading its result) cannot deadlock
        # with the reader
        while True:
            with plock:
                while not pending and not done_reading[0]:
                    plock.wait()
                if not pending:
                    return
                item = pending.popleft()
            emit(*item)  # blocks on the future in this thread only

    emit_thread = threading.Thread(target=emitter, daemon=True)
    emit_thread.start()
    try:
        for line in src:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                wav_path = req["wav"]
            except Exception as e:
                # one malformed line must not abandon the run
                say({"line": line[:200], "error": str(e)})
                continue
            out_path = req.get("out") or (os.path.splitext(wav_path)[0] + "_gen.bvh")
            inflight.acquire()  # released by emit() when the result lands
            try:
                style = parse_style(req.get("style"), wav_path)
                fut = server.submit(load_wav_16k(wav_path), style)
                with plock:
                    pending.append((req, out_path, fut))
                    plock.notify()
            except Exception as e:
                inflight.release()
                say({"wav": wav_path, "error": str(e)})
    finally:
        with plock:
            done_reading[0] = True
            plock.notify()
        emit_thread.join()
        if args.requests:
            src.close()
        server.stop()
    counters = server.counters()
    say(counters)
    return {**counters, "capture_seconds": server.sampler.capture_seconds}


if __name__ == "__main__":
    main()
