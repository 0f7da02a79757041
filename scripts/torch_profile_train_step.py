#!/usr/bin/env python3
"""Device-time breakdown of one full-width ZEGGS training step of the PyTorch port.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/torch_profile_train_step.py [--steps 5] [--batch 300]

A seeded random MDM at the published widths (1141 / 256 / 8 layers / 4 heads /
ff 1024, plain PyTorch ops, as training runs) takes `--steps` steps of
`train.state.make_train_step` (AdamW, dropout 0.1, condition drop 0.1, cosine
1000) on seeded random windows of 88 frames, after warm-up steps, under
`torch.profiler` (CUPTI), in three modes: "device_cache" (the windows on the
card, each batch gathered there, float32 with TF32 off), "bf16_device_cache"
(the same under bf16 autocast) and "host" (float32, each batch gathered from
host numpy arrays and copied from pinned memory, as `cli/train.py` without
`--device_cache`). For each mode it prints one JSON line: the wall time a step
(synchronized, profiler off) and with the profiler on, the device-busy time a
step (union of kernel intervals) and its share of the wall time with the
profiler off, the kernels launched a step, the device time a
step by kind of kernel (matrix products, dropout and other random draws,
softmax, LayerNorm forward and backward, reductions, elementwise, copies,
dtype casts and concatenations, gathers and scatters, other) and the 15
kernels with the most device time.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from torch_profile_denoiser import busy_us, short_name  # noqa: E402

# first match wins; names are lower-cased kernel names
KINDS = (("matmul", ("gemm", "cutlass", "xmma", "sm90_", "sm80_", "ampere_", "cublas",
                     "nvjet")),
         ("random", ("philox", "distribution", "uniform", "normal", "random")),
         ("softmax", ("softmax",)),
         ("layer_norm", ("layer_norm", "layernorm", "gammabeta")),
         ("reduce", ("reduce", "norm_kernel", "sum_kernel")),
         ("copy_cat", ("catarray", "copy", "cat_", "memcpy")),
         ("gather_scatter", ("index", "gather", "scatter")),
         ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    low = name.lower()
    for label, keys in KINDS:
        if any(k in low for k in keys):
            return label
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--batch", type=int, default=300)
    p.add_argument("--windows", type=int, default=333)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this profile needs the card", file=sys.stderr)
        return 2
    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch import resolve_device
    from diffusestylegesture_torch.data.device_cache import DeviceWindowCache
    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.train import TrainConfig, TrainState, make_train_step
    from diffusestylegesture_torch.train.loop import batch_to_device

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    rng = np.random.default_rng(0)
    host = {"motion": rng.standard_normal((args.windows, 88, 1141)).astype(np.float32),
            "style": np.eye(6, dtype=np.float32)[rng.integers(0, 6, args.windows)],
            "wavlm": rng.standard_normal((args.windows, 88, 1024)).astype(np.float32)}
    cache = DeviceWindowCache(host, dev)
    sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=dev)

    for mode in ("device_cache", "bf16_device_cache", "host"):
        cfg = TrainConfig(compute_dtype="bfloat16" if mode.startswith("bf16") else "float32")
        torch.manual_seed(0)
        state = TrainState(MDM(MDMConfig(impl="plain")).to(dev), cfg, 1000)
        step = make_train_step(sched, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        order = np.random.default_rng(1)

        def one_step():
            if mode == "host":
                idx = order.integers(0, args.windows, args.batch)
                batch = batch_to_device({k: v[idx] for k, v in host.items()}, dev)
            else:
                batch = cache.sample_batch(cache.arrays, gen, args.batch)
            return step(state, batch, gen)

        for _ in range(args.warmup):
            one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                metrics = one_step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            raise SystemExit("torch.profiler recorded no device activity")
        by_kind, by_name = {}, {}
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + us
            d = by_name.setdefault(short_name(e.name), [0.0, 0])
            d[0] += us
            d[1] += 1
        busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / args.steps
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        print(json.dumps(dict(
            profile="train_step", mode=mode, batch=args.batch, card=card,
            wall_ms_per_step=plain_wall_ms, wall_ms_per_step_profiled=wall_ms,
            device_busy_ms_per_step=busy_ms, busy_share=busy_ms / plain_wall_ms,
            launches_per_step=len(kernels) / args.steps,
            device_ms_per_step_by_kind={k: v / 1e3 / args.steps
                                        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
            top_kernels=[dict(name=n, ms_per_step=t / 1e3 / args.steps, count=c / args.steps)
                         for n, (t, c) in top],
            loss=float(metrics["loss"]))))
        del state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
