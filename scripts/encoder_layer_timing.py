#!/usr/bin/env python3
"""Device time of the encoder-layer CUDA kernel (`csrc/encoder_layer.cu`), whole
and grid by grid, and where each grid's time goes.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/encoder_layer_timing.py [--sources A.cu B.cu ...] [--phases]

Each source (default: the package's) is built with the package's nvcc flags,
one nvcc each, all at once. Each is held against the plain PyTorch layer at
the denoiser's shapes (x (B, 89, 256), H 4, F 1024, B = 1 and 2, float32 and
mxu_bf16 modes), then timed in turns (the sources in order, then reversed;
twice) with `chip_smoke.device_ms`. A source of the seven-grid design that
came before (its `dsg_encoder_layer` takes no grid and no mode) is called
through that entry point, in float32 only. For each source of this design, each of the
layer's four grids is also timed alone: the same launch the layer makes,
`which` = 1..4, repeated.

With --phases the first source is built again with -DDSG_PHASES and an
8-layer chain runs; of its last layer, for each grid, it prints the median
over blocks of each phase mark (µs after the block started, from its SM's
cycle counter at the SM clock nvidia-smi reads) and of the block's start (µs
after the layer's first block started, from the global timer). The marks are
the `mark(grid, i)` calls in the source.

Prints one JSON line per measurement, then the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms  # noqa: E402
from diffusestylegesture_torch.ops import build  # noqa: E402

SOURCE = os.path.join(build.CSRC_DIR, "encoder_layer.cu")
T, D, H, F, LAYERS = 89, 256, 4, 1024, 8
GRIDS = ("qkv", "attention", "out_ff1", "ff2_ln2")
# kPhaseGrids x kPhaseBlocks x kPhaseMarks x {global timer ns, SM cycles}
PHASE_SHAPE = (4, 256, 8, 2)
# the seven-grid design's entry point: x, 12 weights, work, out, B, T, D, H, F, act, scale, eps, stream
OLD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def compile_all(sources, out_dir):
    """{name: (path, extra nvcc flags)} -> {name: ctypes library}."""
    from diffusestylegesture_torch.ops.encoder_layer import LAYER_ARGTYPES

    procs = {}
    for name, (src, flags) in sources.items():
        so = os.path.join(out_dir, f"lib{len(procs)}.so")
        procs[name] = (so, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, *flags,
                                             "-o", so, src], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = {f"{k}<{'bf16' if b == '1' else 'f32'}>": int(n) for k, b, n in re.findall(
            r"entry function '\w*?[a-z]\d+encoder_layer_(\w+?)ILb([01])\w*'"
            r"(?:(?!entry function).)*?Used (\d+) registers", log, re.S)}
        print(json.dumps(dict(source=name, registers=regs)))
        lib = ctypes.CDLL(so)
        lib.current = hasattr(lib, "dsg_encoder_layer_phases")
        lib.dsg_encoder_layer.argtypes = LAYER_ARGTYPES if lib.current else OLD_ARGTYPES
        lib.dsg_encoder_layer_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.dsg_encoder_layer_workspace_floats.restype = ctypes.c_size_t
        libs[name] = lib
    return libs


class Call:
    """dsg_encoder_layer of one library on fixed tensors."""

    def __init__(self, lib, x, layer, stream):
        import torch

        from diffusestylegesture_torch.ops.encoder_layer import layer_weights

        B = x.shape[0]
        self.lib, self.x, self.stream = lib, x, stream
        self.work = torch.empty(lib.dsg_encoder_layer_workspace_floats(B, T, D, F),
                                device=x.device)
        self.out = torch.empty_like(x)
        self.weights = [w.data_ptr() for w in layer_weights(layer)]
        self.B = B

    def __call__(self, bf16=False, which=0, x=None, out=None):
        x = self.x if x is None else x
        out = self.out if out is None else out
        head = [x.data_ptr(), *self.weights, self.work.data_ptr(), out.data_ptr(),
                self.B, T, D, H, F, 1]
        if self.lib.current:
            err = self.lib.dsg_encoder_layer(which, *head, int(bf16), (D // H) ** -0.5, 1e-5,
                                             self.stream)
        else:
            err = self.lib.dsg_encoder_layer(*head, (D // H) ** -0.5, 1e-5, self.stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out


def sm_clock_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.split()[0])


def phases(lib, calls, bf16):
    """Median phase marks of the last layer of an 8-layer chain, per grid."""
    import numpy as np
    import torch

    buf = (ctypes.c_ulonglong * int(np.prod(PHASE_SHAPE)))()
    h = calls.x
    for _ in range(LAYERS):
        h = calls(bf16, x=h, out=torch.empty_like(h))
    torch.cuda.synchronize()
    mhz = sm_clock_mhz()
    if lib.dsg_encoder_layer_phases(buf) != len(buf):
        raise SystemExit("the phase build recorded no marks")
    marks = np.frombuffer(buf, dtype=np.uint64).reshape(PHASE_SHAPE).astype(np.int64)
    # blocks of this layer: started within 1 ms of the grid's last block start
    starts = marks[:, :, 0, 0]
    first = min(starts[g][starts[g] > 0].max() for g in range(4)) - 1_000_000
    t0 = min(starts[g][starts[g] >= first].min() for g in range(4))
    out = {}
    for g, name in enumerate(GRIDS):
        live = starts[g] >= first
        cyc = marks[g, live, :, 1]
        used = [i for i in range(1, PHASE_SHAPE[2]) if (cyc[:, i] != 0).all()]
        out[name] = dict(
            blocks=int(live.sum()),
            start_us=float(np.median(starts[g][live] - t0) / 1e3),
            last_start_us=float((starts[g][live] - t0).max() / 1e3),
            marks_us=[float(np.median(cyc[:, i] - cyc[:, 0]) / mhz) for i in used],
            marks_max_us=[float((cyc[:, i] - cyc[:, 0]).max() / mhz) for i in used],
            slowest_block_us=float((cyc[:, used[-1]] - cyc[:, 0]).max() / mhz))
    return dict(sm_clock_mhz=mhz, grids=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sources", nargs="*", default=[SOURCE], help="versions of encoder_layer.cu")
    p.add_argument("--phases", action="store_true", help="also record the phase marks")
    p.add_argument("--batch", nargs="*", type=int, default=[1, 2])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this run needs the card", file=sys.stderr)
        return 2
    from diffusestylegesture_torch import resolve_device
    from diffusestylegesture_torch.models.transformer import TorchEncoderLayer

    dev = resolve_device("cuda")
    names = [f"{i}:{os.path.relpath(s, ROOT)}" for i, s in enumerate(args.sources)]
    sources = {n: (s, []) for n, s in zip(names, args.sources)}
    if args.phases:
        sources["phases"] = (args.sources[0], ["-DDSG_PHASES"])
    with tempfile.TemporaryDirectory(prefix="dsg_el_timing_") as tmp:
        libs = compile_all(sources, tmp)
        stream = torch.cuda.current_stream(dev).cuda_stream
        torch.manual_seed(0)
        layer = TorchEncoderLayer(D, H, F).to(dev).eval()
        for B in args.batch:
            x = torch.randn(B, T, D, device=dev)
            calls = {n: Call(libs[n], x, layer, stream) for n in libs}
            for bf16 in (False, True):
                timed = [n for n in names if libs[n].current or not bf16]
                with torch.no_grad():
                    ref = layer(x, mxu_bf16=bf16)
                errs = {}
                for n in timed + (["phases"] if args.phases else []):
                    out = calls[n](bf16)
                    torch.cuda.synchronize()
                    errs[n] = (out - ref).abs().max().item()
                times = {n: [] for n in timed}
                for _ in range(2):
                    for n in timed + timed[::-1]:
                        times[n].append(device_ms(lambda: calls[n](bf16)) * 1e3)
                for n in timed:
                    print(json.dumps(dict(source=n, batch=B, mxu_bf16=bf16,
                                          layer_us=sorted(times[n]), max_abs_err=errs[n])))
                for n in timed:
                    if libs[n].current:
                        grid_us = {g: device_ms(lambda: calls[n](bf16, which=i + 1)) * 1e3
                                   for i, g in enumerate(GRIDS)}
                        print(json.dumps(dict(source=n, batch=B, mxu_bf16=bf16,
                                              grids_alone_us=grid_us)))
                first = names[0]
                if args.phases:
                    print(json.dumps(dict(source=first, batch=B, mxu_bf16=bf16,
                                          max_abs_err=errs["phases"],
                                          **phases(libs["phases"], calls["phases"], bf16))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
