#!/usr/bin/env python3
"""WavLM-Large's device time a window through `ZeggsSampler.encode`, by the
chunk its graph is captured for.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/wavlm_chunk_timing.py [--chunks 4 8 16] [--windows 16 32 48 64 80] [--iters 5]

A seeded random WavLM-Large (24 × 1024, float32, TF32 off) encodes ZEGGS
windows of 88 frames (70,400 samples) on the graph path. For each chunk C
(the sampler's `ENCODE_CHUNK`, set on the instance) and each window count W,
`encode` runs W / C replays of the graph captured for C windows (one replay
of the graph captured for W windows where W is not a multiple of C above
it); the reference row, `graph`, captures one graph a window count, as the
server did before it packed windows. Times are CUDA events around `--iters`
calls after a warm-up. Prints one JSON line a (chunk, windows): the card,
its power limit, µs a call and µs a window; then the largest difference of
each chunk's features from the per-count graph's at the largest W. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> dict:
    import torch

    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "unknown"
    return {"device": torch.cuda.get_device_name(0), "power_limit": limit}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chunks", type=int, nargs="+", default=[4, 8, 16])
    p.add_argument("--windows", type=int, nargs="+", default=[16, 32, 48, 64, 80])
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)

    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch import resolve_device
    from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig, make_zeggs_wavlm_fn
    from diffusestylegesture_torch.sample import ZeggsEngineConfig, ZeggsSampler

    dev = resolve_device("cuda")
    if dev.type != "cuda":
        raise SystemExit("needs an NVIDIA card")
    torch.manual_seed(0)
    with torch.device(dev):
        wavlm = WavLM(WavLMConfig()).eval()
    ecfg = ZeggsEngineConfig()
    S = ecfg.samples_per_seed + ecfg.samples_per_stride
    sched = D.Schedule.create(D.named_beta_schedule("cosine", 10), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    windows = 0.1 * torch.randn(max(args.windows), S, device=dev, generator=gen)
    info = card()
    feats = {}
    for chunk in [None] + args.chunks:
        sampler = ZeggsSampler(lambda *a: None, make_zeggs_wavlm_fn(ecfg.n_poses), sched, ecfg,
                               device=dev)
        # None: a chunk above every count, so each count captures its own graph
        sampler.ENCODE_CHUNK = chunk or max(args.windows) + 1
        for W in args.windows:
            with torch.inference_mode():
                sampler.encode(wavlm, windows[:W])  # capture at first use
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    out = sampler.encode(wavlm, windows[:W])
                end.record()
                torch.cuda.synchronize()
            us = start.elapsed_time(end) * 1e3 / args.iters
            print(json.dumps({**info, "chunk": chunk or "graph", "windows": W,
                              "us_per_call": round(us, 1), "us_per_window": round(us / W, 1),
                              "graphs": len(sampler._encoders)}), flush=True)
            if W == max(args.windows):
                feats[chunk] = out.clone()
        del sampler
        torch.cuda.empty_cache()
    ref = feats[None]
    for chunk in args.chunks:
        print(json.dumps({"chunk": chunk, "max_abs_diff_vs_graph":
                          float((feats[chunk] - ref).abs().max()),
                          "ref_rms": float(ref.pow(2).mean().sqrt())}), flush=True)


if __name__ == "__main__":
    main()
