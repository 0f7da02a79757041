#!/usr/bin/env python3
"""Device time of the encoder-layer CUDA kernel (`csrc/encoder_layer.cu`), whole
and grid by grid, and where each grid's time goes.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/encoder_layer_timing.py [--sources A.cu B.cu ...] [--phases]
                                            [--shapes 1x89x256 16x89x256 ...] [--w-paths]

Each source (default: the package's) is built with the package's nvcc flags,
one nvcc each, all at once. Each is held against the plain PyTorch layer at
each shape (B x T x D, H 4, F 1024; default: the ZEGGS denoiser at B = 1, the
BEAT one at B = 1, the TWH one at B = 1 and 2 (CFG), the server's B = 16 and
the distillation teacher's B = 300), in the float32 and mxu_bf16 modes, then
timed in turns (the sources in order, then reversed; twice) with
`chip_smoke.device_ms`. Four generations of the source are told apart by
what they export: the wgmma design with weight planes
(`dsg_encoder_layer_split`; takes the plan of `ops/encoder_layer.py::plan`,
seven ints a step, and the layer's planes), the wgmma design before it
(`dsg_encoder_layer_steps`: five steps, seven grids; six ints a step, the
first six of this package's plan, which may differ from the plan its own
checkout gives: time it with that checkout's script), the four-grid mma.sync
design (`dsg_encoder_layer_phases`; e.g. `git show
bcab30f:diffusestylegesture_torch/csrc/encoder_layer.cu`) and the first,
seven-grid design (float32 only). For each source of the first three
designs, each step of the layer is also timed alone: the same launches the
layer makes, `which` = 1.., repeated.

With --w-paths each source with weight planes is also timed in float32 with
every GEMM grid on the weight planes (`f32_planes`) and with every one
splitting its weight tiles in shared memory (`f32_in_place`), the plan
otherwise the same (`ops/encoder_layer.py::_plan(..., planes=)`): what the
plan's choice between the two rests on.

With --phases the first source is built again with -DDSG_PHASES and an
8-layer chain runs; of its last layer, for each grid, it prints the median
over blocks of each phase mark (µs after the block started, from its SM's
cycle counter at the SM clock nvidia-smi reads) and of the block's start (µs
after the layer's first block started, from the global timer). The marks are
the `mark(grid, i)` calls in the source.

Prints one JSON line per measurement (with the plan the wgmma source ran),
then the card's name and power limit. Imports nothing of JAX.
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
H, F, LAYERS = 4, 1024, 8
SHAPES = ("1x89x256", "1x151x384", "1x151x512", "2x151x512", "16x89x256", "300x89x256")
GRIDS = {5: ("qkv", "attention", "out_ln1", "ff1", "ff2_ln2"),
         4: ("qkv", "attention", "out_ff1", "ff2_ln2")}
# kGrids x kPhaseBlocks x kPhaseMarks x {global timer ns, SM cycles}
PHASE_BLOCKS, PHASE_MARKS = 256, 8
# the seven-grid design's entry point: x, 12 weights, work, out, B, T, D, H, F, act, scale, eps, stream
OLD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# the mma.sync design's: which, x, 12 weights, work, out, B, T, D, H, F, act, bf16, scale, eps, stream
MMA_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# the wgmma design's before weight planes: MMA_ARGTYPES and the plan
WGMMA_ARGTYPES = MMA_ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
# operand modes: (mxu_bf16, the f32 GEMM grids' weight path: None as the plan says,
# True on weight planes, False split in shared memory)
MODES = {"f32": (False, None), "bf16": (True, None), "f32_planes": (False, True),
         "f32_in_place": (False, False)}


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
        spills = {}  # the most of any instantiation of each kernel
        for k, b, n in re.findall(r"entry function '\w*?[a-z]\d+encoder_layer_(\w+?)ILb([01])\w*'"
                                  r"(?:(?!entry function).)*?(\d+) bytes spill stores", log, re.S):
            key = f"{k}<{'bf16' if b == '1' else 'f32'}>"
            spills[key] = max(spills.get(key, 0), int(n))
        print(json.dumps(dict(source=name, registers=regs, spill_store_bytes=spills)))
        lib = ctypes.CDLL(so)
        # 5: the wgmma design (takes a plan), 4: mma.sync, 0: the seven-grid one
        lib.grids = (lib.dsg_encoder_layer_steps() if hasattr(lib, "dsg_encoder_layer_steps")
                     else 4 if hasattr(lib, "dsg_encoder_layer_phases") else 0)
        lib.planes = hasattr(lib, "dsg_encoder_layer_split")
        lib.dsg_encoder_layer.argtypes = (LAYER_ARGTYPES if lib.planes else {
            5: WGMMA_ARGTYPES, 4: MMA_ARGTYPES, 0: OLD_ARGTYPES}[lib.grids])
        lib.dsg_encoder_layer_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.dsg_encoder_layer_workspace_floats.restype = ctypes.c_size_t
        libs[name] = lib
    return libs


class Call:
    """dsg_encoder_layer of one library on fixed tensors."""

    def __init__(self, lib, x, layer, stream):
        import torch

        from diffusestylegesture_torch.ops import encoder_layer as el

        self.B, self.T, self.D = x.shape
        self.lib, self.x, self.stream = lib, x, stream
        self.work = torch.empty(lib.dsg_encoder_layer_workspace_floats(self.B, self.T, self.D, F),
                                device=x.device)
        self.out = torch.empty_like(x)
        weights = el.layer_weights(layer)
        self.weights = [w.data_ptr() for w in weights]
        sms = el.sm_count(x.device.index)
        self.plans = {mode: el._plan(self.B, self.T, self.D, H, F, bf16, sms, planes)[0]
                      for mode, (bf16, planes) in MODES.items()}
        width = el.PLAN_INTS if lib.planes else el.PLAN_INTS - 1
        self.ints = {mode: (ctypes.c_int * (width * len(g)))(
            *[v for grid in g for v in grid.ints()[:width]]) for mode, g in self.plans.items()}
        self.planes = [el.weight_planes(layer, weights, x.device).data_ptr()] if lib.planes else []

    def __call__(self, mode="f32", which=0, x=None, out=None):
        x = self.x if x is None else x
        out = self.out if out is None else out
        D, bf16 = self.D, MODES[mode][0]
        head = [x.data_ptr(), *self.weights, *self.planes, self.work.data_ptr(), out.data_ptr(),
                self.B, self.T, D, H, F, 1]
        if self.lib.grids == 5:
            err = self.lib.dsg_encoder_layer(which, *head, int(bf16), (D // H) ** -0.5, 1e-5,
                                             ctypes.addressof(self.ints[mode]), self.stream)
        elif self.lib.grids == 4:
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


def phases(lib, calls, mode):
    """Median phase marks of the last layer of an 8-layer chain, per grid."""
    import numpy as np
    import torch

    grids = GRIDS[lib.grids]
    shape = (len(grids), PHASE_BLOCKS, PHASE_MARKS, 2)
    buf = (ctypes.c_ulonglong * int(np.prod(shape)))()
    h = calls.x
    for _ in range(LAYERS):
        h = calls(mode, x=h, out=torch.empty_like(h))
    torch.cuda.synchronize()
    mhz = sm_clock_mhz()
    if lib.dsg_encoder_layer_phases(buf) != len(buf):
        raise SystemExit("the phase build recorded no marks")
    marks = np.frombuffer(buf, dtype=np.uint64).reshape(shape).astype(np.int64)
    # blocks of this layer: started within 1 ms of the grid's last block start
    starts = marks[:, :, 0, 0]
    first = min(starts[g][starts[g] > 0].max() for g in range(len(grids))) - 1_000_000
    t0 = min(starts[g][starts[g] >= first].min() for g in range(len(grids)))
    out = {}
    for g, name in enumerate(grids):
        live = starts[g] >= first
        cyc = marks[g, live, :, 1]
        used = [i for i in range(1, PHASE_MARKS) if (cyc[:, i] != 0).all()]
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
    p.add_argument("--shapes", nargs="*", default=list(SHAPES), help="B x T x D")
    p.add_argument("--w-paths", action="store_true",
                   help="also time f32 with every GEMM grid on weight planes and with none")
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
        for shape in args.shapes:
            B, T, D = map(int, shape.split("x"))
            torch.manual_seed(0)
            layer = TorchEncoderLayer(D, H, F).to(dev).eval()
            x = torch.randn(B, T, D, device=dev)
            calls = {n: Call(libs[n], x, layer, stream) for n in libs}
            modes = ["f32", "bf16"] + (["f32_planes", "f32_in_place"] if args.w_paths else [])
            for mode in modes:
                bf16, way = MODES[mode]
                timed = [n for n in names
                         if (libs[n].grids or not bf16) and (way is None or libs[n].planes)]
                if not timed:
                    continue
                with torch.no_grad():
                    ref = layer(x, mxu_bf16=bf16)
                errs, outs = {}, {}
                for n in timed + (["phases"] if args.phases and way is None else []):
                    outs[n] = calls[n](mode).clone()
                    torch.cuda.synchronize()
                    errs[n] = (outs[n] - ref).abs().max().item()
                times = {n: [] for n in timed}
                iters = 10 if B * T > 10_000 else 30
                for _ in range(2):
                    for n in timed + timed[::-1]:
                        times[n].append(device_ms(lambda: calls[n](mode), iters=iters) * 1e3)
                for n in timed:
                    plan = ([g.describe() for g in calls[n].plans[mode]] if libs[n].grids == 5
                            else None)
                    # the two weight paths against the plan's own: bitwise equal or not
                    same = (bool(torch.equal(outs[n], calls[n]("f32").clone()))
                            if way is not None else None)
                    print(json.dumps(dict(source=n, shape=[B, T, D], heads=H, mode=mode,
                                          mxu_bf16=bf16, layer_us=sorted(times[n]),
                                          max_abs_err=errs[n], equal_to_f32=same, plan=plan)))
                for n in timed:
                    if libs[n].grids:
                        grid_us = {g: device_ms(lambda: calls[n](mode, which=i + 1),
                                                iters=iters) * 1e3
                                   for i, g in enumerate(GRIDS[libs[n].grids])}
                        print(json.dumps(dict(source=n, shape=[B, T, D], mode=mode,
                                              grids_alone_us=grid_us)))
                first = names[0]
                if args.phases and way is None:
                    print(json.dumps(dict(source=first, shape=[B, T, D], mode=mode,
                                          max_abs_err=errs["phases"],
                                          **phases(libs["phases"], calls["phases"], mode))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
