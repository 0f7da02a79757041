#!/usr/bin/env python3
"""Device-time breakdown of one full-width ZEGGS denoiser call of the PyTorch port.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/torch_profile_denoiser.py [--iters 20] [--batch 1 2]

A seeded random MDM at the published widths (1141 / 256 / 8 layers / 4
heads / ff 1024) is called `--iters` times per batch size and path
("kernel": the hand-written CUDA kernels; "plain": their plain PyTorch
versions; "graph": the kernel path's call captured once into a CUDA graph
by `utils/graphs.py` and replayed) under `torch.profiler` (CUPTI). For each,
it prints one JSON line: the device time per call of every CUDA kernel by
name, the kernels launched per call, the device-busy time per call (union of
kernel intervals), the host wall time per call with the profiler on, the
busy share of that wall time, and the encoder-layer
kernel's grids per call and per layer (its kernels are the ones named
`encoder_layer_*`) with their device time. Batch 2 is the
classifier-free-guidance batch. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:80]


ENCODER_LAYER_KERNEL = "encoder_layer_"


def profile_calls(call, iters: int, layers: int):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("torch.profiler recorded no device activity")
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(short_name(e.name), [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    el_grids = sum(c for n, (_, c) in rows if ENCODER_LAYER_KERNEL in n) / iters
    return dict(
        kernels_per_call=[dict(name=n, us=t / iters, count=c / iters) for n, (t, c) in rows],
        launches_per_call=len(kernels) / iters,
        encoder_layer_grids_per_call=el_grids,
        encoder_layer_grids_per_layer=el_grids / layers,
        encoder_layer_us_per_call=sum(
            t for n, (t, _) in rows if ENCODER_LAYER_KERNEL in n) / iters,
        device_busy_us_per_call=busy / iters,
        wall_us_per_call_profiled=wall_us / iters,
        busy_share=busy / wall_us)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this profile needs the card", file=sys.stderr)
        return 2
    from diffusestylegesture_torch import resolve_device
    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.ops import build
    from diffusestylegesture_torch.utils.graphs import GraphSet

    dev = resolve_device("cuda")
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    torch.manual_seed(0)
    kernel_model = MDM(MDMConfig()).to(dev).eval()
    plain_model = MDM(MDMConfig(impl="plain")).to(dev).eval()
    plain_model.load_state_dict(kernel_model.state_dict())
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.inference_mode():
        for B in args.batch:
            x = torch.randn(B, 1141, 1, 88, generator=g).to(dev)
            cond = {"style": torch.eye(6)[:1].repeat(B, 1).to(dev),
                    "seed": torch.randn(B, 1141, 1, 8, generator=g).to(dev),
                    "audio": torch.randn(B, 88, 1024, generator=g).to(dev),
                    "mask_local": torch.ones(B, 88, dtype=torch.bool, device=dev)}
            t = torch.full((B,), 500, device=dev)
            out = torch.empty_like(x)
            replay, _ = GraphSet(dev).capture(lambda: out.copy_(kernel_model(x, t, cond)))
            for impl, call in (("kernel", lambda: kernel_model(x, t, cond)),
                               ("graph", replay.replay),
                               ("plain", lambda: plain_model(x, t, cond))):
                res = profile_calls(call, args.iters, kernel_model.cfg.num_layers)
                print(json.dumps(dict(profile="denoiser_call", batch=B, impl=impl, card=card,
                                      **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
