#!/usr/bin/env python3
"""Device time of the local-attention CUDA kernel (`csrc/local_attention.cu`)
alone, beside the launch itself, and where its time goes.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/local_attention_timing.py [--sources A.cu B.cu ...] [--phases]

Each source (default: the package's) is built with the package's nvcc flags,
one nvcc each, all at once; registers per kernel come from the build log and
the shared memory of a block from the library. At the three denoisers' shapes
(ZEGGS (B·8, 88, 32) w 11, BEAT (B·8, 150, 48) w 15, TWH (B·8, 150, 64) w 15,
B = 1 and 2) each is held against the plain PyTorch version, then timed in
turns (the sources in order, then reversed; twice) with
`chip_smoke.device_ms`, through its C entry point: the kernel's own launch
and nothing else. A source of the first design (its `dsg_local_attention`
takes packed contiguous tensors and a uint8 mask; e.g. from
`git show <commit>:diffusestylegesture_torch/csrc/local_attention.cu`) is
called through that entry point with the mask already cast. For each source
of this design the cases are: q = k = v with the boolean mask (`aliased`, the
denoisers' call), with `mask=None`, distinct q, k, v, the strided-in /
merged-out layout, and an empty kernel launched with the same grid, block,
shared memory and launch attributes.

With --phases the first source is built again with -DDSG_PHASES and, after
eight back-to-back calls at each shape (B = 1), it prints the median over
blocks of each phase mark of the last call (µs after the block started, from
its SM's cycle counter at the SM clock nvidia-smi reads; taken by the warp of
the window's last query row) and the span from the first block's start to the
last block's end (global timer). The marks are the `mark(i)` calls in the
source: 1 after `griddepcontrol.wait`, 2 after the thread's own copies
landed, 3 after the barrier, 4 after the softmax, 5 after the value product's
loop, 6 after the store.

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

from chip_smoke import LOCAL_ATTENTION_SHAPES as SHAPES  # noqa: E402  (N, w, D) by denoiser
from chip_smoke import device_ms  # noqa: E402
from diffusestylegesture_torch.ops import build  # noqa: E402

SOURCE = os.path.join(build.CSRC_DIR, "local_attention.cu")
HEADS = 8
# the source's mark(1) .. mark(6); mark(0) is the block's start
PHASE_MARKS = ("wait", "copies", "barrier", "softmax", "values", "store")
# the first design's entry point: q, k, v, mask, out, bh, n, w, d, heads, scale, stream
OLD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def compile_all(sources, out_dir):
    """{name: (path, extra nvcc flags)} -> {name: ctypes library}."""
    from diffusestylegesture_torch.ops.local_attention import KERNEL_ARGTYPES

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
        regs = {}
        for keys, vec, n in re.findall(
                r"entry function '\w*local_attention_kernelILi(\d)ELb([01])E\w*'"
                r"(?:(?!entry function).)*?Used (\d+) registers", log, re.S):
            regs[f"keys{keys}_{'vec' if vec == '1' else 'scalar'}"] = int(n)
        for n in re.findall(r"entry function '\w*local_attention_kernelEPK\w*'"
                            r"(?:(?!entry function).)*?Used (\d+) registers", log, re.S):
            regs["first_design"] = int(n)
        lib = ctypes.CDLL(so)
        lib.current = hasattr(lib, "dsg_local_attention_empty")
        lib.dsg_local_attention.argtypes = KERNEL_ARGTYPES if lib.current else OLD_ARGTYPES
        if lib.current:
            lib.dsg_local_attention_empty.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.dsg_local_attention_phases.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                                       ctypes.POINTER(ctypes.c_int)]
            lib.dsg_local_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
            lib.dsg_local_attention_smem_bytes.restype = ctypes.c_size_t
            smem = {f"{s}_{'aliased' if a else 'distinct'}":
                    lib.dsg_local_attention_smem_bytes(w, d, a, 1)
                    for s, (_, w, d) in SHAPES.items() for a in (1, 0)}
        else:
            lib.dsg_local_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
            lib.dsg_local_attention_smem_bytes.restype = ctypes.c_size_t
            smem = {s: lib.dsg_local_attention_smem_bytes(w, d) for s, (_, w, d) in SHAPES.items()}
        print(json.dumps(dict(source=name, registers=regs, shared_memory_bytes=smem)))
        libs[name] = lib
    return libs


def strides3(t):
    """Element strides of the batch, head and position axes of a (B, H, N, D) tensor."""
    return t.stride()[:3]


class Cases:
    """The timed calls of one library at one shape, on fixed tensors."""

    def __init__(self, lib, B, shape, dev, stream):
        import torch

        n, w, d = shape
        self.lib, self.stream, self.B, self.shape = lib, stream, B, shape
        g = torch.Generator(device="cpu").manual_seed(B * 1000 + n + d)
        # (B, N, H·D) activations; their (B, H, N, D) views; packed contiguous copies
        self.base = [torch.randn(B, n, HEADS * d, generator=g).to(dev) for _ in range(3)]
        self.views = [t.view(B, n, HEADS, d).transpose(1, 2) for t in self.base]
        self.packed = [t.contiguous() for t in self.views]
        self.mask = torch.ones(B, n, dtype=torch.bool, device=dev)
        self.mask_u8 = self.mask.to(torch.uint8)
        self.out = torch.empty(B, HEADS, n, d, device=dev)
        self.merged = torch.empty(B, n, HEADS * d, device=dev)
        self.merged_view = self.merged.view(B, n, HEADS, d).transpose(1, 2)

    def _launch(self, q, k, v, mask, out):
        n, w, d = self.shape
        if self.lib.current:
            alias = q is k and k is v
            err = self.lib.dsg_local_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(), self.B, HEADS, n, w, d,
                *strides3(q), *strides3(k), *strides3(v), *strides3(out), int(alias), d ** -0.5,
                self.stream)
        else:
            err = self.lib.dsg_local_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else self.mask_u8.data_ptr(), out.data_ptr(),
                self.B * HEADS, n, w, d, HEADS, d ** -0.5, self.stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out

    def aliased(self):
        q = self.packed[0]
        return self._launch(q, q, q, self.mask, self.out)

    def no_mask(self):
        q = self.packed[0]
        return self._launch(q, q, q, None, self.out)

    def distinct(self):
        return self._launch(*self.packed, self.mask, self.out)

    def merged_layout(self):
        q = self.views[0]
        return self._launch(q, q, q, self.mask, self.merged_view)

    def empty(self):
        n, w, d = self.shape
        err = self.lib.dsg_local_attention_empty(self.B, HEADS, n, w, d, self.stream)
        if err:
            raise SystemExit(f"empty launch failed: CUDA error {err}")

    def references(self):
        """{case: (result, plain result)} of every case this library runs."""
        import torch

        from diffusestylegesture_torch.models.local_attention import local_attention_plain

        n, w, d = self.shape
        flat = [t.reshape(self.B * HEADS, n, d) for t in self.packed]
        ref_alias = local_attention_plain(flat[0], flat[0], flat[0], w, self.mask, heads=HEADS)
        got = {"aliased": (self.aliased().clone(), ref_alias)}
        if self.lib.current:
            got["no_mask"] = (self.no_mask().clone(), local_attention_plain(
                flat[0], flat[0], flat[0], w, None, heads=HEADS))
            got["distinct"] = (self.distinct().clone(), local_attention_plain(
                *flat, w, self.mask, heads=HEADS))
            got["merged_layout"] = (self.merged_layout().clone(), ref_alias)
        torch.cuda.synchronize()
        return got


def sm_clock_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.split()[0])


def phases(lib, cases):
    """Median phase marks over the blocks of the last of eight back-to-back calls."""
    import numpy as np
    import torch

    # the record's shape (blocks, marks a block, {global timer ns, SM cycles}) is the library's
    dims = (ctypes.c_int * 3)()
    size = lib.dsg_local_attention_phases(None, dims)
    if size == 0 or dims[1] <= len(PHASE_MARKS):
        raise SystemExit("the phase build records no marks, or fewer than this script names")
    buf = (ctypes.c_ulonglong * size)()
    for _ in range(8):
        cases.aliased()
    torch.cuda.synchronize()
    mhz = sm_clock_mhz()
    if lib.dsg_local_attention_phases(buf, dims) != size:
        raise SystemExit("the phase marks could not be copied from the card")
    n, w, _ = cases.shape
    blocks = min(cases.B * HEADS * (n // w), dims[0])
    marks = np.frombuffer(buf, dtype=np.uint64).reshape(tuple(dims)).astype(np.int64)[:blocks]
    cyc, ns = marks[:, :, 1], marks[:, :, 0]
    last = len(PHASE_MARKS)
    return dict(
        sm_clock_mhz=mhz, blocks=blocks,
        marks_us={name: float(np.median(cyc[:, i + 1] - cyc[:, 0]) / mhz)
                  for i, name in enumerate(PHASE_MARKS)},
        marks_max_us={name: float((cyc[:, i + 1] - cyc[:, 0]).max() / mhz)
                      for i, name in enumerate(PHASE_MARKS)},
        last_block_start_us=float((ns[:, 0].max() - ns[:, 0].min()) / 1e3),
        first_start_to_last_end_us=float((ns[:, last].max() - ns[:, 0].min()) / 1e3))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sources", nargs="*", default=[SOURCE], help="versions of local_attention.cu")
    p.add_argument("--phases", action="store_true", help="also record the phase marks")
    p.add_argument("--batch", nargs="*", type=int, default=[1, 2])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this run needs the card", file=sys.stderr)
        return 2
    from diffusestylegesture_torch import resolve_device

    dev = resolve_device("cuda")
    names = [f"{i}:{os.path.relpath(s, ROOT)}" for i, s in enumerate(args.sources)]
    sources = {n: (s, []) for n, s in zip(names, args.sources)}
    if args.phases:
        sources["phases"] = (args.sources[0], ["-DDSG_PHASES"])
    with tempfile.TemporaryDirectory(prefix="dsg_la_timing_") as tmp:
        libs = compile_all(sources, tmp)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for shape_name, shape in SHAPES.items():
            for B in args.batch:
                cases = {n: Cases(libs[n], B, shape, dev, stream) for n in libs}
                errs = {n: {case: (out.reshape(ref.shape) - ref).abs().max().item()
                            for case, (out, ref) in cases[n].references().items()}
                        for n in libs}
                times = {n: {case: [] for case in errs[n]} for n in names}
                for _ in range(2):
                    for n in names + names[::-1]:
                        for case in errs[n]:
                            times[n][case].append(
                                device_ms(getattr(cases[n], case), iters=100) * 1e3)
                        if libs[n].current:
                            times[n].setdefault("empty", []).append(
                                device_ms(cases[n].empty, iters=100) * 1e3)
                for n in names:
                    print(json.dumps(dict(
                        source=n, shape=shape_name, batch=B, max_abs_err=errs[n],
                        us={case: sorted(t) for case, t in times[n].items()})))
                if args.phases and B == 1:
                    print(json.dumps(dict(source=names[0], shape=shape_name, batch=B,
                                          max_abs_err=errs["phases"],
                                          **phases(libs["phases"], cases["phases"]))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
