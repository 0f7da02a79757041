#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`diffusestylegesture_torch`).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. record the card (nvidia-smi name and power limit); TF32 off;
  2. build every CUDA kernel from `diffusestylegesture_torch/csrc/` (one nvcc
     per source, all at once) and time the build;
  3. local-attention kernel vs its plain PyTorch version at the ZEGGS, BEAT and
     TWH denoisers' shapes ((B·8, 88, 32) window 11, (B·8, 150, 48) and
     (B·8, 150, 64) window 15), B = 1 and 2 (and 16, the server's batch, at
     ZEGGS), all-true / partial / no mask,
     aliased (q = k = v) and distinct q, k, v, packed contiguous and
     strided-in / merged-out, atol 1e-5; two calls bitwise equal; times of the
     kernel with the boolean mask and with no mask, of an empty kernel launched
     the same way, of the plain version and of SDPA (block-causal boolean mask);
  4. encoder-layer kernel vs the plain layer at the ZEGGS (B, 89, 256), BEAT
     (B, 151, 384) and TWH (B, 151, 512) trunk shapes, B = 1 and 2 (and 16 at
     ZEGGS), with 8
     layers of seeded weights each, in both operand modes: float32 (3xTF32,
     the main path) at atol 1e-4 per layer, `mxu_bf16` against the plain bf16
     layer at atol 1e-2 per layer; two calls on the same input bitwise equal;
     kernel, plain and nn.TransformerEncoderLayer times (under bf16 autocast
     for the bf16 mode), each mode with the bound of its tensor-core work,
     and the plan of each row (row tile, n-tile, K-split cluster, stages and
     blocks of each of the layer's five steps' GEMM and attention grids);
  5. end to end at full width through `cli.sample.main`: a seeded random MDM
     (1141 / 256 / 8 layers / 4 heads / ff 1024) and WavLM-Large (24 layers,
     d 1024) in reference checkpoint layout, a seeded 12.5 s wav (3 windows);
     DDPM-1000, the gated dpmpp5 mode and dpmpp5 with --serve_fast, each on the
     CUDA-graph engine, launch counters reset before and read after each run
     and held to the expected counts (kernel B only in its bf16 mode under
     --serve_fast), capture seconds beside generate seconds; the same runs in
     this process through a captured engine and through the eager loop,
     timed, bitwise equal to each other and to the CLI's poses; graph vs
     eager bitwise equal at guidance 1.5 and for a 2-clip generate_multi_clip;
     --serve_fast within RMS/std 2e-2 of float32 and the kernel path within
     2e-3 rel of the plain path, dpmpp5 on the same injected noise; WavLM-Large
     in float32 and bf16, and one denoiser call eager, replayed from a graph
     and through the plain path (device and wall ms);
  6. ZEGGS training at full width (MDM 1141 / 256 / 8 layers / 4 heads / ff 1024,
     batch 300 × 88 frames, cosine 1000): four seeded 60 s clips (wav + a 60 fps
     BVH of the 75-joint skeleton, written by the port's `bvh.save`) →
     `cli.prepare_data` → `cli.train` on `configs/zeggs.yml` with WavLM-Large
     features from phase 5's checkpoint, in float32 (TF32 off, stopped at 20
     steps and resumed to 40), `--bf16`, `--device_cache` and both (30 steps
     each);
     every logged loss finite; no kernel launched while training (the training
     path runs the plain ops); after one step every MDM parameter has a finite,
     non-zero gradient; master weights, moments and EMA float32 under bf16; on
     one fixed batch at lr 1e-3 the loss falls over 20 steps; the checkpoint
     served by `cli.sample --model_path <dir>/40` in dpmpp5 on the CUDA-graph
     engine through kernels A (15 launches) and B (120); steady-state ms/step,
     windows/s, peak memory and the share of the f32 and bf16 peaks; the
     device-cache runs replay one captured step, and the same step in float32
     and bf16 is held bitwise equal over 3 steps to the eager one and timed
     both ways in this process;
  7. distillation and evaluation: `cli.distill` on phase 6's checkpoint, 2
     stages (1000 → 500 → 250) at batch 300, each chunk of 10 steps one
     replayed graph, the teacher through kernels A (2 launches a step) and B
     (16); the same step captured and eager, bitwise equal over 3 steps and
     timed; the teacher's call at B = 300 through the kernels and the plain
     ops, and each kernel at its shapes there against its plain version (A
     1e-5, B 1e-4 per layer) and its library call; both students served by
     `cli.sample` through A and B with finite BVH; `cli.eval --embedding
     autoencoder --kid --wav` on the student's poses against the teacher's
     dpmpp5 poses (one stem), every key of the JAX CLI's line; the
     autoencoder's step captured and eager, bitwise equal and timed;
  8. BEAT/TWH serving at the published widths through `cli.sample_beat.main`:
     seeded random MDMPlus weights in reference layout (TWH 2232 / 512, BEAT v0
     2052 / 384, 8 layers, 4 heads, ff 1024, window 15), phase 5's WavLM-Large,
     a seeded 16 s wav (479 frames, 4 windows) with word timings, a 300-d
     `.vec` file, a seed clip and stats; TWH DiffuseStyleGesture+ on the live
     `--wav --tsv --word_vectors --wavlm_path` path in DDPM-1000, dpmpp5 and
     dpmpp5 --serve_fast, TWH DiffuseStyleGesture++ and BEAT DiffuseStyleGesture
     in dpmpp5 from the features' npy; launch counters from 0 around each run,
     held to A = calls and B = 8 x calls (bf16 mode only under --serve_fast);
     motion (real_n, motion_dim), finite; in this process graph and eager
     bitwise equal (and the npy runs equal to the CLI's motion), the TWH kernel
     path within 2e-3 rel of the plain path and --serve_fast within RMS/std
     2e-2 of float32 on the same injected noise; WavLM-Large over the clip's
     5 s chunks and one TWH denoiser call eager, replayed and plain (device and
     wall ms), host feature seconds;
  9. BEAT/TWH data preparation and training at the published widths: seeded
     60 s clips (TWH: four, a 30 fps BVH of the 62 TWH bones, 6 channels each,
     speakers from a metadata csv; BEAT: two, a 120 fps BVH of Hips + 74 target
     joints + one more; 16 kHz wavs, a word every 0.45 s) → `cli.prepare_data`
     (4 spawned workers, WavLM-Large from phase 5 on the card, phase 8's
     `.vec`): audio 1133, text 302 / 301, gesture 744 / 684 wide, stats, the
     seconds split → `cli.train` on configs/beat_twh.yml (batch 350 × 150
     frames, `h5file` the prepared store): TWH DiffuseStyleGesture+ in float32
     (stopped at 20 steps, resumed to 40), `--bf16 --device_cache` (30 steps),
     DiffuseStyleGesture++ and BEAT DiffuseStyleGesture (10 steps each);
     every logged loss finite, no kernel launched while training, every
     MDMPlus parameter with a finite non-zero gradient after one step, float32
     master weights / moments / EMA under bf16, the loss falling over 20 steps
     on one batch at lr 1e-3, the device-cache step captured bitwise equal to
     eager over 3 steps (float32 and bf16, timed both ways); the checkpoint
     `<save_dir>/40` served by `cli.sample_beat` in dpmpp5 from a training
     clip's features through kernels A (20 launches) and B (160), finite
     (479, 744) motion, written as BVH by `twh_features_to_bvh` with the
     pipeline fitted on a training BVH and parsed back with 479 frames;
     features → BVH → features within 1e-4 for a TWH and a BEAT training clip;
  10. the serving surfaces on phase 5's checkpoint and WavLM-Large: `cli.serve`
     on a JSONL of four seeded 1- and 2-window clips in DDPM-1000 at max_batch
     16, float32 and --serve_fast (A a multiple of 1000 launches, B 8 × A in
     the run's mode); a library `GestureServer` burst of 64 mixed-length
     requests (1-5 windows, buckets 1 / 2 / 5) in dpmpp5 after one request per
     bucket captured its graphs: requests/s, frames/s, p50 / p99 latency,
     batches, capture seconds, peak memory and (a second burst under
     torch.profiler) the card's busy share; the same clips one at a time
     through `ZeggsSampler.generate`; a ZEGGS stream (the 12.5 s wav) and a
     TWH DiffuseStyleGesture+ stream (phase 8's features) over 0.5 s pushes,
     ms from a window's last input to its motion, each within 2e-3 rel of
     its batch engine; `restyle_window` (strength 0.5) and an in-between
     `edit_motion` on one window on the 1000-step schedule (kept frames
     within 1e-4); kernels A and B launched on every one of these paths;
  11. the ZeroEGGS RNN system at the published widths of `ZeroEGGSConfig`
     (hidden 512, 2 GRU layers, speech 128, style 64, 75 joints, 60 fps)
     through `cli.zeroeggs`: `prepare` on phase 6's clips, `train` 30 steps
     at the CLI's defaults (ms/step; no diffusion kernel launched), `generate`
     a 12.5 s clip with two style examples in `add` and `stitch` (750-frame
     BVHs), and the rollout captured as a CUDA graph against its eager run,
     bitwise equal, ms per rollout step both ways;
  12. the rest of the gesture models at the ZEGGS widths with seeded weights:
     (a) the MFCC-conditioned MDM (`audio_feat='mfcc'`) on phase 5's wav
     through `ZeggsSampler` with `make_mfcc_window_fn` (host features) on
     CUDA graphs, DDPM-1000 (A 3,000 / B 24,000) and dpmpp5 (15 / 120), graph
     and eager bitwise equal, host MFCC seconds beside generate seconds, the
     kernel path within 2e-3 rel of the plain path on the same noise, a
     host-feature stream within 2e-3 rel of the batch engine with its window
     latency; (b) `cross_local_attention5` (A 15 / B 0), plain
     `cross_local_attention` (15 / 120), style1 / style2 `trans_enc` and
     `mytrans_enc` (0 / 120), `trans_dec` and `gru` (0 / 0), MFCC audio: one
     replayed denoiser call against the plain path (2e-3 rel; device and wall
     ms) and a dpmpp5 3-window generate on graphs, launches held; (c) MoE:
     `cli.train --moe_experts 4 --device_cache` on phase 6's prepared clips
     (batch 300, 20 steps, float32; loss and `moe_aux` finite; no kernel
     launched), the step captured against eager over 3 steps, bitwise equal;
     `cli.sample` on its checkpoint in dpmpp5 (expert count inferred; A 15 /
     B 0) and one denoiser call of it through the kernel and the plain path
     (routing flips counted, 2e-3 rel); (d) the baselines at B = 8:
     `WavEncoder` on (8, 64000), `GeneratorLinear` / `GeneratorGRU` and their
     `sample`, `Seq2SeqNet`, `GeneratorDiff` loss + backward and a 250-step
     sample, DiffWave loss + backward and a 50-step sample, the upstream
     local-attention README's `LocalTransformer` (256 tokens, dim 512, depth
     6, window 256) generating 512 tokens, `Tisa` at T = 240: timed, finite,
     shaped, no diffusion kernel launched;
  13. text-to-motion at the HumanML3D widths with seeded weights: (a) kernel B
     at the trunk's shapes, x (B, T, 512), H 4, F 1024, T 121 / 177 / 197
     (6 s, 8.8 s, 9.8 s: key tiles of 32, the last one ragged) at
     B 2 / 6 / 64 (one prompt, 3 repetitions and 32 prompts under CFG), and
     (2, 400, 256): 8 seeded layers in both operand modes against the plain
     layer (1e-4 / 1e-2 per layer), two calls bitwise equal, times beside
     the plain layer, nn.TransformerEncoderLayer (bf16 autocast for bf16) and
     the bound, and the plan each shape takes (tiles, clusters, stages and
     key tile of each of the five steps); (b) a seeded HumanML3D-format corpus (160 clips of 263-d joint
     vecs, 40-196 frames at 20 fps, `caption#tokens#0.0#0.0` texts, a split,
     Mean / Std, a 300-d GloVe table) → `cli.train_t2m` at the published
     widths (512 / 8 layers / ff 1024, 196 frames, batch 64, cosine-1000, a
     seeded hash-tokenized CLIP ViT-B/32 text tower: 512 wide, 12 layers, 8
     heads, 77 tokens) in float32 and `--bf16`, 20 steps each: finite losses,
     ms/step, peak memory, no kernel launched; (c) `cli.generate` on the
     float32 checkpoint, one prompt, 3 repetitions, guidance 2.5, on CUDA
     graphs: DDPM-1000 at 9.8 s (196 frames, T 197, key tiles) and at 6 s
     (120 frames), DDIM 50 at 9.8 s, launches held to kernel B 8,000 /
     8,000 / 400 and kernel A 0, `results.npy` (3, 22, 3, frames) finite,
     capture seconds beside generate seconds; the 9.8 s DDPM run through the
     eager loop (in this process) bitwise equal to the CLI's on graphs; the kernel path within 2e-3 rel
     of the plain path (DDIM 50, the same seed); one replayed B = 6 TextMDM
     call (device and wall ms); (d) seeded evaluators at the published widths:
     the T2M evaluator's matching score, R-precision top 1-3, FID and
     diversity of (c)'s features against the corpus, STGCN on (64, 24, 6, 60)
     rot6d, the motion discriminator on (64, 72, 60), `Rotation2xyz` over a
     seeded synthetic SMPL (6,890 vertices, 24 joints, 10 betas) at
     (64, 25, 6, 60): finite, timed;
  14. export: phase 9's TWH and BEAT training BVHs and its written BVH through
     `cli.export_gltf --player` to GLB and the player HTML; `read_glb` reads
     each back with one node a joint and one animation channel a rotated or
     translated joint; timed (no matplotlib: the card's machine has none);
  15. parallelism over every visible card (`diffusestylegesture_torch/parallel/`):
     (a) `ZeggsSampler.generate(mesh=)` at B = 16 in dpmpp5 and DDPM-1000 and
     `BeatTwhSampler.generate(mesh=)` TWH + in dpmpp5 over a serving mesh of
     the cards (one replica and its graphs a card), each within 2e-3 rel of
     the one-card run, every card launching kernels A and B as the one-card
     run does, frames/s both ways; (b) `cli.train` at full width (batch 300,
     20 steps, device cache) on phase 6's clips in a spawned NCCL group of one
     rank a card under --use_mesh, --fsdp, --tp, --sp and --pp (degree
     min(2, cards), 4 microbatches; one card: degree 1), the logged losses
     within 1e-5 rel of the one-process run (--pp: of the one-process --pp 1
     run), no kernel launched, ms/step and peak memory per rank; (c) in that
     group one B = 16 ZEGGS denoiser call through sequence-parallel local
     attention (kernel A over [halo | shard]) and through the pipelined trunk
     (kernel B per stage), each within 2e-3 rel of the plain path, launches
     held, device ms beside the unsharded kernel path's;
  16. print the card line, a `kernels` JSON line, an `e2e` JSON line, a `train`
     JSON line, a `distill` JSON line, a `beat_twh` JSON line, a
     `beat_twh_train` JSON line, a `serving` JSON line, a `zeroeggs` JSON line,
     a `models` JSON line, a `t2m` JSON line, an `export` JSON line, a
     `parallel` JSON line and, last, {"ok": true, "device": {...}}.

Device times of the kernels come from CUDA events around back-to-back calls
queued behind a sleep kernel, so host launch overhead is not in them.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
SEED = 20260

ATOL_LOCAL_ATTENTION = 1e-5
ATOL_ENCODER_LAYER = 1e-4
ATOL_ENCODER_LAYER_BF16 = 1e-2
E2E_REL = 2e-3
BF16_TOL = 2e-2  # bench.py's gate of the bf16 serving mode: RMS(bf16 - f32) / std(f32)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, queued behind
    a sleep kernel so the host's launch rate does not enter the time. Fails
    if queueing the calls outlasted the sleep (a full launch queue blocks the
    host): the time would then be the host's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning while the calls are queued
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    sleep_ms = slept.elapsed_time(start)
    check(enqueue_ms < sleep_ms, f"queueing {iters} calls took {enqueue_ms:.1f} ms, longer "
                                 f"than the {sleep_ms:.1f} ms sleep: not a device time")
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 3 --------------------------------------------------------------------


# (N, w, D) of the local attention in the ZEGGS, BEAT and TWH denoisers, 8 heads each
LOCAL_ATTENTION_SHAPES = {"zeggs": (88, 11, 32), "beat": (150, 15, 48), "twh": (150, 15, 64)}
# batches each shape is checked and timed at: 1, 2 (CFG) and, for ZEGGS, the
# serving surfaces' max_batch of 16 (phase 10)
SERVER_BATCH = 16
SHAPE_BATCHES = {"zeggs": (1, 2, SERVER_BATCH), "beat": (1, 2), "twh": (1, 2)}


def phase_local_attention(dev):
    import torch
    import torch.nn.functional as F

    from diffusestylegesture_torch.models.local_attention import local_attention_plain
    from diffusestylegesture_torch.ops import local_attention as la

    H = 8
    g = torch.Generator(device="cpu").manual_seed(SEED)
    max_err = 0.0
    timings = {}
    for shape, (n, w, d) in LOCAL_ATTENTION_SHAPES.items():
        timings[shape] = {}
        for B in SHAPE_BATCHES[shape]:
            # (B, N, H·D) activations, their strided (B, H, N, D) views (what the
            # denoiser hands the kernel) and packed contiguous (B·H, N, D) copies
            base = [torch.randn(B, n, H * d, generator=g).to(dev) for _ in range(3)]
            views = [t.view(B, n, H, d).transpose(1, 2) for t in base]
            packed = [t.reshape(B * H, n, d) for t in views]
            merged = torch.empty(B, n, H * d, device=dev)
            merged_view = merged.view(B, n, H, d).transpose(1, 2)
            full = torch.ones(B, n, dtype=torch.bool, device=dev)
            partial = full.clone()
            partial[-1, -7:] = False
            worst = 0.0
            for mask in (full, partial, None):
                for aliased in (True, False):
                    pk = [packed[0]] * 3 if aliased else packed
                    vw = [views[0]] * 3 if aliased else views
                    ref = local_attention_plain(*pk, w, mask, heads=H)
                    out = la.local_attention(*pk, w, mask, heads=H)
                    merged.fill_(float("nan"))
                    la.local_attention(*vw, w, mask, heads=H, out=merged_view)
                    torch.cuda.synchronize()
                    worst = max(worst, (out - ref).abs().max().item(),
                                (merged_view.reshape(ref.shape) - ref).abs().max().item())
            print(f"local_attention {shape} B={B}: max_abs_err {worst:.3e} over masks all / "
                  f"partial / none, aliased and distinct q/k/v, packed and strided-in / "
                  f"merged-out")
            check(worst <= ATOL_LOCAL_ATTENTION, f"local_attention {shape} B={B} err {worst}")
            max_err = max(max_err, worst)
            first = la.local_attention(*packed, w, partial, heads=H)
            check(torch.equal(first, la.local_attention(*packed, w, partial, heads=H)),
                  f"local_attention {shape} B={B}: two calls on one input differ")
            # and the denoiser's variant: q = k = v strided in, merged out
            x = views[0]
            first = la.local_attention(x, x, x, w, full, heads=H, out=merged_view).clone()
            merged.fill_(float("nan"))
            check(torch.equal(first, la.local_attention(x, x, x, w, full, heads=H,
                                                        out=merged_view)),
                  f"local_attention {shape} B={B}: two aliased merged-out calls differ")

            # the main path's mask is all True: window 0's pad keys are masked, so
            # each query sees the keys of its own and the previous window up to itself
            q, k, v = packed
            pos = torch.arange(n, device=dev)
            allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] >= (pos[:, None] // w - 1) * w)
            sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
            sdpa_err = (sdpa - la.local_attention(q, k, v, w, full, heads=H)).abs().max().item()
            check(sdpa_err <= 1e-4, f"SDPA yardstick disagrees with the kernel: {sdpa_err}")

            # the denoiser's call reads one tensor (q = k = v) and the mask and
            # writes one; with distinct q, k, v there are three to read
            tensor_bytes = 4 * B * H * n * d
            flops = 2 * 2 * B * H * n * 2 * w * d
            timings[shape][B] = dict(
                # the denoiser's call: q = k = v strided in, merged out, boolean mask
                ms=device_ms(lambda: la.local_attention(x, x, x, w, full, heads=H,
                                                        out=merged_view)),
                no_mask_ms=device_ms(lambda: la.local_attention(x, x, x, w, None, heads=H,
                                                                out=merged_view)),
                # three tiles instead of one, packed contiguous in and out
                distinct_ms=device_ms(lambda: la.local_attention(q, k, v, w, full, heads=H)),
                empty_launch_ms=device_ms(lambda: la.launch_empty(B, H, n, w, d, dev)),
                plain_ms=device_ms(lambda: local_attention_plain(q, k, v, w, full, heads=H)),
                library_ms=device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)),
                bound=bound(2 * tensor_bytes + B * n, flops),
                distinct_bound_ms=bound(4 * tensor_bytes + B * n, flops)[0])
            print(f"local_attention {shape} B={B} timings: {json.dumps(timings[shape][B])}")
    return max_err, timings


# ---- phase 4 --------------------------------------------------------------------


def encoder_layer_cost(B, T, D, H, F):
    weights = 3 * D * D + 3 * D + D * D + D + 2 * D + F * D + F + D * F + D + 2 * D
    nbytes = 4 * (2 * B * T * D + weights)
    flops = 2 * B * T * (3 * D * D + D * D + 2 * D * F) + 2 * 2 * B * H * T * T * (D // H)
    return nbytes, flops


# Kernel B's operand modes: (wrapper flag, per-layer bar, operations per
# float32-accurate product and the tensor-core rate they run at). The f32 mode
# is 3xTF32: three TF32 products per product.
ENCODER_MODES = {"f32": (False, ATOL_ENCODER_LAYER, 3, TF32_FLOPS_PER_S),
                 "bf16": (True, ATOL_ENCODER_LAYER_BF16, 1, BF16_FLOPS_PER_S)}


# (T, D) of the trunk in the ZEGGS, BEAT and TWH denoisers (frames + the token), H 4, F 1024
ENCODER_SHAPES = {"zeggs": (89, 256), "beat": (151, 384), "twh": (151, 512)}


def phase_encoder_layer(dev):
    import torch
    from torch import nn

    from diffusestylegesture_torch.models.transformer import TorchTransformerEncoder
    from diffusestylegesture_torch.ops import encoder_layer as el

    H, F, L = 4, 1024, 8
    max_err = {mode: 0.0 for mode in ENCODER_MODES}
    timings = {mode: {shape: {} for shape in ENCODER_SHAPES} for mode in ENCODER_MODES}
    for shape, (T, D) in ENCODER_SHAPES.items():
        torch.manual_seed(SEED)
        trunk = TorchTransformerEncoder(L, D, H, F, "gelu").to(dev).eval()
        with torch.no_grad():
            for B in SHAPE_BATCHES[shape]:
                x = torch.randn(B, T, D, device=dev)
                layer = trunk.layers[0]
                ref = nn.TransformerEncoderLayer(D, H, F, dropout=0.0, activation="gelu",
                                                 batch_first=True, norm_first=False).to(dev).eval()
                ref.load_state_dict(layer.state_dict())
                lib_err = (ref(x) - el.encoder_layer(x, layer)).abs().max().item()
                check(lib_err <= 1e-3, f"nn.TransformerEncoderLayer disagrees: {lib_err}")
                nbytes, flops = encoder_layer_cost(B, T, D, H, F)
                for mode, (bf16, atol, products, rate) in ENCODER_MODES.items():
                    h, worst = x, 0.0
                    for i, lyr in enumerate(trunk.layers):
                        out = el.encoder_layer(h, lyr, mxu_bf16=bf16)
                        torch.cuda.synchronize()
                        err = (out - lyr(h, mxu_bf16=bf16)).abs().max().item()
                        check(err <= atol, f"encoder_layer {mode} {shape} B={B} layer {i} "
                                           f"err {err}")
                        worst = max(worst, err)
                        h = out
                    max_err[mode] = max(max_err[mode], worst)
                    stack_err = (h - trunk(x, impl="plain", mxu_bf16=bf16)).abs().max().item()
                    again = el.encoder_layer(x, layer, mxu_bf16=bf16)
                    check(torch.equal(again, el.encoder_layer(x, layer, mxu_bf16=bf16)),
                          f"encoder_layer {mode} {shape} B={B}: two calls on one input differ")
                    print(f"encoder_layer {mode} {shape} ({B}, {T}, {D}): max per-layer err "
                          f"{worst:.3e} (atol {atol:g}), 8-layer stack err {stack_err:.3e}, "
                          f"repeat calls bitwise equal")

                    def library():
                        if not bf16:
                            return ref(x)
                        with torch.autocast("cuda", dtype=torch.bfloat16):
                            return ref(x)

                    if bf16:
                        auto_err = (library().float() - layer(x, mxu_bf16=True)).abs().max().item()
                        print(f"nn.TransformerEncoderLayer under bf16 autocast vs the plain "
                              f"bf16 layer: max abs err {auto_err:.3e}")
                        check(auto_err <= 0.1, f"bf16 autocast layer disagrees: {auto_err}")
                    # the plain bf16 layer and the autocast layer launch ~3x the
                    # kernels of the f32 ones: 10 calls stay within the launch queue
                    iters = 10 if bf16 else 30
                    timings[mode][shape][B] = dict(
                        ms=device_ms(lambda: el.encoder_layer(x, layer, mxu_bf16=bf16)),
                        plain_ms=device_ms(lambda: layer(x, mxu_bf16=bf16), iters=iters),
                        library_ms=device_ms(library, iters=iters),
                        bound=bound(nbytes, products * flops, rate), max_abs_err=worst,
                        plan=el.describe_plan(B, T, D, H, F, bf16))
                    print(f"encoder_layer {mode} {shape} B={B} timings: "
                          f"{json.dumps(timings[mode][shape][B])}")
    return max_err, timings


# ---- phase 5 --------------------------------------------------------------------


def write_full_width_run(tmp, dev):
    """Seeded random checkpoints at the published widths, in reference layout."""
    import numpy as np
    import torch
    import yaml
    from scipy.io import wavfile

    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig

    torch.manual_seed(SEED)
    mdm_pt = os.path.join(tmp, "model000000000.pt")
    torch.save(MDM(MDMConfig()).state_dict(), mdm_pt)

    wcfg = WavLMConfig()
    with torch.device(dev):
        wavlm = WavLM(wcfg)
    sd = {k: v.cpu() for k, v in wavlm.state_dict().items()}
    del wavlm
    w = sd.pop("encoder.pos_conv.0.weight")  # back to the checkpoint's weight norm
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_v"] = w
    cfg_dict = dict(extractor_mode=wcfg.extractor_mode, encoder_layers=wcfg.encoder_layers,
                    encoder_embed_dim=wcfg.encoder_embed_dim,
                    encoder_ffn_embed_dim=wcfg.encoder_ffn_embed_dim,
                    encoder_attention_heads=wcfg.encoder_attention_heads,
                    layer_norm_first=wcfg.layer_norm_first,
                    conv_feature_layers="[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2",
                    conv_pos=wcfg.conv_pos, conv_pos_groups=wcfg.conv_pos_groups,
                    relative_position_embedding=True, num_buckets=wcfg.num_buckets,
                    max_distance=wcfg.max_distance, gru_rel_pos=True, normalize=True)
    wavlm_pt = os.path.join(tmp, "WavLM-Large.pt")
    torch.save({"cfg": cfg_dict, "model": sd}, wavlm_pt)

    rng = np.random.default_rng(SEED)
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    np.savez(os.path.join(data_dir, "mean.npz"), mean=rng.standard_normal(1141).astype(np.float32))
    np.savez(os.path.join(data_dir, "std.npz"),
             std=(0.5 + rng.random(1141)).astype(np.float32))
    sr, seconds = 16000, 12.5
    t = np.arange(int(sr * seconds)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 2 * t))
           + 0.05 * rng.standard_normal(t.shape))
    wav_path = os.path.join(tmp, "015_Happy_4_x_1_0.wav")
    wavfile.write(wav_path, sr, (wav * 12000).astype(np.int16))

    cfg = dict(dataset="ZEGGS", n_poses=88, motion_resampling_framerate=20, n_seed=8,
               njoints=1141, latent_dim=256, ff_size=1024, num_layers=8, num_heads=4,
               cond_mask_prob=0.1, cond_mode="cross_local_attention3_style1",
               audio_feat="wavlm", diffusion_steps=1000, noise_schedule="cosine",
               data_dir=data_dir, wavlm_path=wavlm_pt)
    cfg_path = os.path.join(tmp, "zeggs.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path, mdm_pt, wav_path


def zeggs_sampler(dev, sched, sampler="dpmpp", guidance=0.0, graphs=None):
    """The CLI's engine at the chip run's configuration (3 windows, B = 1)."""
    from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
    from diffusestylegesture_torch.sample import ZeggsEngineConfig, ZeggsSampler

    return ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                        make_zeggs_wavlm_fn(88), sched,
                        ZeggsEngineConfig(sampler=sampler, guidance_scale=guidance),
                        device=dev, graphs=graphs)


def timed(fn):
    """(result, wall seconds) of fn(), whose result is on the host."""
    t0 = time.perf_counter()
    res = fn()
    return res, time.perf_counter() - t0


def phase_end_to_end(dev, tmp, card):
    import numpy as np
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import sample as sample_cli
    from diffusestylegesture_torch.config import load_yaml_config
    from diffusestylegesture_torch.data import load_wav_16k
    from diffusestylegesture_torch.models.convert import load_reference_mdm, load_wavlm_checkpoint
    from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
    from diffusestylegesture_torch.motion import zeggs_features as zf
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.sample import (ZeggsEngineConfig, generate_multi_clip,
                                                  slice_audio_windows)
    from diffusestylegesture_torch.utils.graphs import GraphSet

    t0 = time.perf_counter()
    cfg_path, mdm_pt, wav_path = write_full_width_run(tmp, dev)
    setup_s = time.perf_counter() - t0
    print(f"full-width checkpoints written in {setup_s:.1f} s")
    cfg = load_yaml_config(cfg_path)
    betas = D.named_beta_schedule("cosine", 1000)
    scheds = {"ddpm1000": D.Schedule.create(betas, device=dev),
              "dpmpp5": D.spaced_schedule(betas, D.space_timesteps(1000, "ddim5"), device=dev)}
    audio = load_wav_16k(wav_path)
    mean = np.load(os.path.join(cfg.data_dir, "mean.npz"))["mean"]
    std = np.load(os.path.join(cfg.data_dir, "std.npz"))["std"]
    style = zf.style_onehot("Happy")[None]  # as the CLI infers it from the file name
    stats = dict(mean=mean, std=std)
    windows, frames = 3, 3 * 80 - 8
    results = {}

    # each path through the CLI, on the graph engine: counters from 0 around the run
    runs = (("ddpm1000", [], 1000, False), ("dpmpp5", ["--sampler", "dpmpp", "--respace", "5"], 5,
                                           False),
            ("dpmpp5_serve_fast", ["--sampler", "dpmpp", "--respace", "5", "--serve_fast"], 5,
             True))
    cli_poses = {}
    for mode, extra, calls_per_window, bf16 in runs:
        la.launches = el.launches = el.launches_bf16 = el.launches_planes = 0
        res, wall = timed(lambda: sample_cli.main(
            ["--config", cfg_path, "--model_path", mdm_pt, "--audiowavlm_path", wav_path,
             "--save_dir", os.path.join(tmp, "out_" + mode), "--seed", "123456"] + extra))
        counts = (la.launches, el.launches, el.launches_bf16)
        calls = windows * calls_per_window
        poses = cli_poses[mode] = res["poses"]
        check(len(res["paths"]) == 1 and os.path.getsize(res["paths"][0]) > 0,
              f"{mode}: no BVH written")
        check(poses.shape == (1, frames, 1141), f"{mode}: poses shape {poses.shape}")
        check(bool(np.isfinite(poses).all()), f"{mode}: non-finite poses")
        expected = (calls, 0, 8 * calls) if bf16 else (calls, 8 * calls, 0)
        check(counts == expected, f"{mode}: launches {counts}, expected {expected}")
        gen_s, cap_s = res["generate_seconds"], res["capture_seconds"]
        # B = 1: every GEMM grid splits its weight tiles in shared memory (the plan)
        planes = el.launches_planes
        check(planes == 0, f"{mode}: {planes} GEMM grids on weight planes at B = 1")
        results[mode] = dict(denoiser_calls=calls, local_attention_launches=counts[0],
                             encoder_layer_launches=counts[1],
                             encoder_layer_bf16_launches=counts[2],
                             encoder_layer_planes_grids=planes, generate_s=gen_s,
                             capture_s=cap_s, cli_wall_s=wall, frames=frames,
                             frames_per_s=frames / gen_s)
        print(f"e2e {mode} (CLI, graphs, capture included) [{card}]: "
              f"{json.dumps(results[mode])}")

    # the same runs again in this process: graphs captured, then timed, and eager
    models = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        wcfg, wavlm = load_wavlm_checkpoint(cfg.wavlm_path, device=dev, dtype=dtype)
        mcfg = sample_cli.mdm_config(cfg, wcfg.encoder_embed_dim, serve_fast=name == "bf16")
        models[name] = (load_reference_mdm(mdm_pt, mcfg, device=dev), wavlm)
    for mode, _, _, bf16 in runs:
        model, wavlm = models["bf16" if bf16 else "f32"]
        sched = scheds[mode.split("_")[0]]
        sampler = "ddpm" if mode == "ddpm1000" else "dpmpp"
        out = {}
        for path, flag in (("graph", None), ("eager", False)):
            s = zeggs_sampler(dev, sched, sampler, graphs=flag)
            if flag is None:  # capture first, then time a call that replays
                s.generate(model, wavlm, audio, style,
                           torch.Generator(device=dev).manual_seed(123456), **stats)
            out[path] = timed(lambda: s.generate(
                model, wavlm, audio, style, torch.Generator(device=dev).manual_seed(123456),
                **stats))
        same = bool(np.array_equal(out["graph"][0], out["eager"][0]))
        as_cli = bool(np.array_equal(out["graph"][0], cli_poses[mode]))
        check(same, f"{mode}: graph and eager poses differ "
                    f"(max {np.abs(out['graph'][0] - out['eager'][0]).max()})")
        check(as_cli, f"{mode}: the CLI's poses differ from the same run in this process")
        results[mode].update(
            graph_generate_s=out["graph"][1], graph_frames_per_s=frames / out["graph"][1],
            eager_generate_s=out["eager"][1], eager_frames_per_s=frames / out["eager"][1],
            graph_equals_eager=same)
        print(f"e2e {mode} in one process [{card}]: graph {out['graph'][1]:.4f} s "
              f"({frames / out['graph'][1]:.1f} frames/s), eager {out['eager'][1]:.4f} s "
              f"({frames / out['eager'][1]:.1f} frames/s), equal {same}")

    # graph vs eager with guidance (B = 2 inside the denoiser) and two clips at once
    gen = lambda: torch.Generator(device=dev).manual_seed(99)  # noqa: E731
    model, wavlm = models["f32"]
    cfg_out = [zeggs_sampler(dev, scheds["dpmpp5"], guidance=1.5, graphs=flag).generate(
        model, wavlm, audio, style, gen(), **stats) for flag in (None, False)]
    clips = [audio, audio[: 16000 * 5]]
    multi = [generate_multi_clip(zeggs_sampler(dev, scheds["dpmpp5"], graphs=flag), model, wavlm,
                                 clips, np.eye(6, dtype=np.float32)[[0, 3]], gen(), **stats)
             for flag in (None, False)]
    results["cfg15_graph_equals_eager"] = bool(np.array_equal(*cfg_out))
    results["multi_clip_graph_equals_eager"] = all(
        np.array_equal(a, b) for a, b in zip(*multi)) and len(multi[0][1]) == 72
    print(f"graph vs eager: CFG 1.5 equal {results['cfg15_graph_equals_eager']}, 2-clip "
          f"generate_multi_clip equal {results['multi_clip_graph_equals_eager']}")
    check(results["cfg15_graph_equals_eager"], "CFG: graph and eager poses differ")
    check(results["multi_clip_graph_equals_eager"], "multi-clip: graph and eager poses differ")

    # bf16 serving against float32, dpmpp5 on the same injected noise; kernel
    # path against plain path
    noise = np.random.default_rng(SEED + 1).standard_normal(
        (windows, 1, 1141, 1, 88)).astype(np.float32)
    poses = {}
    for name in ("f32", "bf16"):
        poses[name] = zeggs_sampler(dev, scheds["dpmpp5"]).generate(
            *models[name], audio, style, gen(), noise_windows=noise, **stats)
    plain = load_reference_mdm(mdm_pt, dataclasses.replace(models["f32"][0].cfg, impl="plain"),
                               device=dev)
    poses["plain"] = zeggs_sampler(dev, scheds["dpmpp5"]).generate(
        plain, models["f32"][1], audio, style, gen(), noise_windows=noise, **stats)
    bf16_err = float(np.sqrt(np.mean((poses["bf16"] - poses["f32"]) ** 2)) / poses["f32"].std())
    print(f"serve_fast vs float32 (dpmpp5, same noise): RMS/std {bf16_err:.3e} "
          f"(bar {BF16_TOL})")
    check(bf16_err < BF16_TOL, f"serve_fast: RMS/std {bf16_err} >= {BF16_TOL}")
    scale = float(np.abs(poses["plain"]).mean())
    err = float(np.abs(poses["f32"] - poses["plain"]).max())
    print(f"kernel path vs plain path (dpmpp5): max abs err {err:.3e}, scale {scale:.3f}")
    check(err <= E2E_REL * max(scale, 1.0), f"kernel vs plain path: {err} > {E2E_REL} rel")

    # WavLM-Large over the clip's windows in each dtype, replayed from a graph
    # as the engine runs it (700-1,000 launches a call: eager calls queued
    # behind the sleep outlast it), and one denoiser call per path: eager
    # kernel path, one graph replay of it, eager plain path
    feats_fn = make_zeggs_wavlm_fn(88)
    win = torch.as_tensor(slice_audio_windows(audio, ZeggsEngineConfig()), device=dev)
    step, wavlm_ms = {}, {}
    with torch.inference_mode():
        for name in ("f32", "bf16"):
            encoder, _ = GraphSet(dev).capture(lambda: feats_fn(models[name][1], win))
            wavlm_ms[name] = device_ms(encoder.replay, iters=5, warmup=1)
        x = torch.randn(1, 1141, 1, 88, device=dev)
        cond = {"style": torch.as_tensor(style, device=dev),
                "seed": torch.zeros(1, 1141, 1, 8, device=dev),
                "audio": feats_fn(models["f32"][1], win)[:1],
                "mask_local": torch.ones(1, 88, dtype=torch.bool, device=dev)}
        tt = torch.tensor([500], device=dev)
        out = torch.empty_like(x)
        replay, _ = GraphSet(dev).capture(lambda: out.copy_(models["f32"][0](x, tt, cond)))
        replay.launches = (0,) * len(replay.launches)  # timing calls are not main-path launches
        for name, fn, iters in (("kernel", lambda: models["f32"][0](x, tt, cond), 4),
                                ("graph_replay", replay.replay, 40),
                                ("plain", lambda: plain(x, tt, cond), 4)):
            # 83 (kernel) to 203 (plain) launches a call: 4 calls stay within
            # the launch queue; a replay is one
            step[name + "_device_ms"] = device_ms(fn, iters=iters, warmup=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            step[name + "_wall_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        replayed = out.clone()
        check(torch.equal(replayed, models["f32"][0](x, tt, cond)),
              "a replayed denoiser call differs from the eager call")
    results.update(kernel_vs_plain_max_abs_err=err, kernel_vs_plain_scale=scale,
                   serve_fast_rms_over_std=bf16_err,
                   wavlm_large_3_windows_ms=wavlm_ms["f32"],
                   wavlm_large_3_windows_bf16_ms=wavlm_ms["bf16"], denoiser_call_b1=step)
    print(f"denoiser call B=1 [{card}]: {json.dumps(step)}; WavLM-Large 3 windows "
          f"{wavlm_ms['f32']:.3f} ms f32, {wavlm_ms['bf16']:.3f} ms bf16")
    return results


# ---- phase 6 --------------------------------------------------------------------


ZEGGS_CLIPS = ("001_Happy_0_x_1_0", "002_Sad_0_x_1_0", "003_Neutral_0_x_1_0", "004_Old_0_x_1_0")
TRAIN_STEPS = 30
RESUME_AT = 20
TRAIN_BATCH = 300  # configs/zeggs.yml's
STEADY_STEPS = 10  # steps a timing turn, captured against eager


def write_zeggs_clips(src, seconds=60, fps=60, sr=16000):
    """Seeded ZEGGS-style clips: a 16 kHz wav and a 60 fps BVH of the 75-joint
    skeleton with smooth rotations and a wandering root, per clip."""
    import numpy as np
    from scipy.io import wavfile

    from diffusestylegesture_torch.motion import bvh, zeggs_features as zf

    for i, name in enumerate(ZEGGS_CLIPS):
        rng = np.random.default_rng(SEED + 10 + i)
        t = np.arange(seconds * sr) / sr
        wav = (0.3 * np.sin(2 * np.pi * (140 + 30 * i) * t) * (1 + np.sin(2 * np.pi * 1.5 * t))
               + 0.05 * rng.standard_normal(t.shape))
        wavfile.write(os.path.join(src, name + ".wav"), sr, (wav * 12000).astype(np.int16))
        T, J = seconds * fps, zf.ZEGGS_NJOINTS
        ft = np.arange(T)[:, None, None] / fps
        rot = rng.uniform(5, 30, (1, J, 3)) * np.sin(
            2 * np.pi * rng.uniform(0.2, 1.5, (1, J, 3)) * ft + rng.uniform(0, 2 * np.pi, (1, J, 3)))
        offsets = rng.uniform(-10, 10, (J, 3)).astype(np.float32)
        pos = np.broadcast_to(offsets, (T, J, 3)).copy()
        pos[:, 0] = [0.0, 100.0, 0.0] + np.cumsum(rng.normal(0, 0.2, (T, 3)), axis=0) * [1, 0, 1]
        bvh.save(os.path.join(src, name + ".bvh"),
                 dict(rotations=rot.astype(np.float32), positions=pos.astype(np.float32),
                      offsets=offsets, parents=zf.ZEGGS_PARENTS, names=list(zf.ZEGGS_BONE_NAMES),
                      order="zyx", frametime=1.0 / fps))


def train_flops_per_window(T=88, njoints=1141, D=256, F=1024, layers=8, n_seed=8, audio=1024,
                           audio_d=64, style_d=64, window=11):
    """Forward FLOPs of the ZEGGS MDM for one window, from its shapes."""
    trunk = layers * (2 * (T + 1) * (4 * D * D + 2 * D * F) + 2 * 2 * (T + 1) ** 2 * D)
    pose = 2 * 2 * T * njoints * D                            # input_process, output_process
    cond = (2 * T * audio * audio_d + 2 * T * (2 * D + audio_d) * D   # audio, input_process2
            + 2 * njoints * n_seed * (D - style_d) + 2 * 2 * D * D)  # seed, timestep MLP
    local = 2 * 2 * T * 2 * window * D                        # each query: 2 windows of keys
    return trunk + pose + cond + local


def steady_ms(runs):
    """Steady-state ms per step from the loops' log boundaries, skipping each
    run's first window (warm-up, graph of the first batch, cache fill)."""
    steps = secs = 0.0
    for loop in runs:
        b = loop.boundaries[1:]
        steps += b[-1][0] - b[0][0]
        secs += b[-1][1] - b[0][1]
    return secs / steps * 1e3


def timed_steps(fn, n):
    """Host ms per call of fn() over n calls, the card synchronized around them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def states_equal(a, b):
    """Two train states bitwise equal: weights, gradients, moments, count, EMA."""
    import torch

    pairs = [(a.params.data, b.params.data), (a.params.grad, b.params.grad),
             (a.optimizer.mu, b.optimizer.mu), (a.optimizer.nu, b.optimizer.nu),
             (a.optimizer.count, b.optimizer.count)]
    if a.ema is not None:
        pairs.append((a.ema, b.ema))
    return all(torch.equal(x, y) for x, y in pairs)


def captured_vs_eager(make, steps=STEADY_STEPS):
    """`make()` → (state, eager step(), capturable step(), generator) of a fresh
    run from one seed. Three steps eagerly and three captured (an eager first
    step, then replays) from two such runs must end bitwise equal, with equal
    generators; then steady ms a step in turns, eager, captured, captured,
    eager. Returns (equal, eager ms, captured ms, the CapturedStep)."""
    import torch

    from diffusestylegesture_torch.utils.graphs import CapturedStep

    eager, eager_step, _, gen_e = make()
    captured, _, device_step, gen_c = make()
    run = CapturedStep(device_step, gen_c.device, [gen_c])
    for _ in range(3):
        eager_step()
        run()
    torch.cuda.synchronize()
    equal = states_equal(eager, captured) and torch.equal(gen_e.get_state(), gen_c.get_state())
    times = {"eager": [], "captured": []}
    for path in ("eager", "captured", "captured", "eager"):
        times[path].append(timed_steps(eager_step if path == "eager" else run, steps))
    return equal, times["eager"], times["captured"], run


def captured_vs_eager_training(cache, dev, card):
    """The device-cache train step at full width, float32 and bf16: captured
    (as `cli/train.py --device_cache` runs it) against eager, in this process."""
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.data.device_cache import make_device_data_train_step
    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.train import TrainConfig, TrainState, make_zeggs_cond_builder

    sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=dev)
    out = {}
    for mode, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        cfg = TrainConfig(lr=3e-5, compute_dtype=dtype)  # configs/zeggs.yml's optimizer
        step = make_device_data_train_step(sched, cfg, make_zeggs_cond_builder(8), TRAIN_BATCH)

        def make():
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                model = MDM(MDMConfig(audio_in_dim=cache.arrays["wavlm"].shape[-1],
                                      impl="plain")).to(dev)
            state = TrainState(model, cfg, 1000)
            gen = torch.Generator(device=dev).manual_seed(0)
            return (state, lambda: step(state, gen, cache.arrays),
                    lambda: step.device_step(state, gen, cache.arrays), gen)

        equal, eager_ms, captured_ms, run = captured_vs_eager(make)
        check(equal, f"train {mode}: the captured step differs from the eager step")
        out[mode] = dict(captured_equals_eager_3_steps=equal, eager_ms_per_step=eager_ms,
                         captured_ms_per_step=captured_ms,
                         eager_windows_per_s=[TRAIN_BATCH / ms * 1e3 for ms in eager_ms],
                         captured_windows_per_s=[TRAIN_BATCH / ms * 1e3 for ms in captured_ms],
                         capture_s=run.capture_seconds)
        print(f"train {mode} device cache, captured vs eager [{card}]: {json.dumps(out[mode])}")
        del run
    return out


def phase_training(dev, tmp, card, wavlm_pt, wav_path):
    import numpy as np
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import prepare_data, sample as sample_cli, train as train_cli
    from diffusestylegesture_torch.data.device_cache import DeviceWindowCache
    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.train import TrainConfig, TrainState, make_train_step

    work = os.path.join(tmp, "zeggs_train")
    src = os.path.join(work, "raw")
    os.makedirs(src)
    os.makedirs(os.path.join(work, "checkpoints"))
    # the yaml's relative paths (./data/zeggs_processed, ./checkpoints/WavLM-Large.pt)
    # resolve under `work`; phase 5's seeded WavLM-Large is the checkpoint
    os.symlink(wavlm_pt, os.path.join(work, "checkpoints", "WavLM-Large.pt"))
    config = os.path.join(HERE, "configs", "zeggs.yml")
    res = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        write_zeggs_clips(src)
        res["write_clips_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prepare_data.main(["--dataset", "ZEGGS", "--source", src, "--target",
                           "data/zeggs_processed", "--workers", "4"])
        res["prepare_data_s"] = time.perf_counter() - t0

        runs = {}
        for mode, flags, steps in (("f32", [], RESUME_AT), ("f32", [], 2 * RESUME_AT),
                                   ("bf16", ["--bf16"], TRAIN_STEPS),
                                   ("device_cache", ["--device_cache"], TRAIN_STEPS),
                                   ("bf16_device_cache", ["--bf16", "--device_cache"],
                                    TRAIN_STEPS)):
            la.launches = el.launches = el.launches_bf16 = 0
            torch.cuda.reset_peak_memory_stats(dev)
            out = train_cli.main(["--config", config, "--num_steps", str(steps), "--save_dir",
                                  os.path.join(work, "out_" + mode), "--log_interval", "10",
                                  "--seed", "0"] + flags)
            counts = (la.launches, el.launches, el.launches_bf16)
            loop, state = out["loop"], out["state"]
            check(counts == (0, 0, 0), f"train {mode}: kernels launched while training {counts}")
            check(state.step == steps, f"train {mode}: ended at step {state.step}, not {steps}")
            losses = [d["loss"] for d in loop.logged]
            check(len(losses) >= 2 and all(np.isfinite(losses)), f"train {mode}: losses {losses}")
            check(bool(torch.isfinite(state.params.data).all()), f"train {mode}: non-finite weights")
            check(state.params.data.dtype == state.optimizer.mu.dtype == state.optimizer.nu.dtype
                  == torch.float32, f"train {mode}: master weights or moments not float32")
            first = mode not in runs
            r = runs.setdefault(mode, dict(loops=[], losses=[], peak_bytes=0))
            r["loops"].append(loop)
            r["losses"] += losses
            r["peak_bytes"] = max(r["peak_bytes"], torch.cuda.max_memory_allocated(dev))
            if mode == "f32" and first:
                check(len(out["dataset"]) == 3 * 111, f"{len(out['dataset'])} windows, not 333")
                res["windows"] = len(out["dataset"])
                res["dataset_s"], res["wavlm_features_s"] = out["prepare_s"], out["wavlm_s"]
                check(out["wavlm_s"] > 0, "WavLM features were not computed")
            if mode == "f32" and not first:
                check(loop.resume_step == RESUME_AT, f"resumed at {loop.resume_step}")
            print(f"train {mode} [{card}]: step {state.step}, losses {losses}, "
                  f"ms/step by window {[d['ms_per_step'] for d in loop.logged]}")
        batch = TRAIN_BATCH
        flops = 3 * batch * train_flops_per_window()
        modes = {}
        for mode, r in runs.items():
            ms = steady_ms(r["loops"])
            modes[mode] = dict(ms_per_step=ms, windows_per_s=batch / ms * 1e3,
                               peak_memory_bytes=r["peak_bytes"],
                               f32_peak_share=flops / (ms / 1e3) / F32_FLOPS_PER_S,
                               bf16_peak_share=flops / (ms / 1e3) / BF16_FLOPS_PER_S,
                               first_loss=r["losses"][0], last_loss=r["losses"][-1],
                               steps=r["loops"][-1].state.step)
        res.update(modes=modes, model_flops_per_step=flops, batch=batch,
                   resumed=dict(stopped_at=RESUME_AT, ended_at=runs["f32"]["loops"][-1].state.step))

        # one step on a fresh full-width model: gradients, dtypes under bf16, EMA
        dataset = out["dataset"]
        cache = DeviceWindowCache.from_zeggs(dataset, dev)
        res["captured_vs_eager"] = captured_vs_eager_training(cache, dev, card)
        fixed = cache.sample_batch(cache.arrays, torch.Generator(device=dev).manual_seed(1), batch)
        sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=dev)

        def fresh(cfg):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                model = MDM(MDMConfig(audio_in_dim=dataset.wavlm.shape[-1], impl="plain")).to(dev)
            return TrainState(model, cfg, 1000), make_train_step(sched, cfg)

        state, step = fresh(TrainConfig(compute_dtype="bfloat16", ema_rate=0.9999))
        step(state, fixed, torch.Generator(device=dev).manual_seed(0))
        bad = [n for n, p in state.model.named_parameters()
               if not (bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().sum()) > 0)]
        check(not bad, f"parameters without a finite non-zero gradient: {bad}")
        f32 = all(t.dtype == torch.float32 for t in (state.params.data, state.optimizer.mu,
                                                      state.optimizer.nu, state.ema))
        check(f32, "bf16: master weights, moments or EMA not float32")
        res["all_params_have_gradients"] = len(list(state.model.parameters()))

        state, step = fresh(TrainConfig(lr=1e-3))
        fixed_losses = [float(step(state, fixed, torch.Generator(device=dev).manual_seed(0))["loss"])
                        for _ in range(20)]
        check(fixed_losses[-1] < fixed_losses[0], f"fixed batch: loss did not fall {fixed_losses}")
        res["fixed_batch_lr1e-3_losses"] = [fixed_losses[0], fixed_losses[-1]]
        del state, step, cache, fixed

        # the trained checkpoint, served through the kernels
        la.launches = el.launches = el.launches_bf16 = 0
        ckpt = os.path.join(work, "out_f32", str(2 * RESUME_AT))
        served = sample_cli.main(["--config", config, "--model_path", ckpt, "--audiowavlm_path",
                                  wav_path, "--sampler", "dpmpp", "--respace", "5", "--save_dir",
                                  os.path.join(work, "served"), "--seed", "123456"])
        counts = (la.launches, el.launches, el.launches_bf16)
        poses = served["poses"]
        check(len(served["paths"]) == 1 and os.path.getsize(served["paths"][0]) > 0,
              "served: no BVH written")
        check(poses.shape == (1, 3 * 80 - 8, 1141) and bool(np.isfinite(poses).all()),
              f"served: poses {poses.shape}, finite {np.isfinite(poses).all()}")
        check(counts == (15, 120, 0), f"served: launches {counts}, expected (15, 120, 0)")
        res["served"] = dict(checkpoint=os.path.relpath(ckpt, work), local_attention_launches=15,
                             encoder_layer_launches=120, generate_s=served["generate_seconds"])
    finally:
        os.chdir(cwd)
    print(f"train [{card}]: {json.dumps(res)}")
    return res, dict(work=work, config=config, checkpoint=ckpt, teacher_poses=poses[0])


# ---- phase 7 --------------------------------------------------------------------


DISTILL_STAGES, DISTILL_STEPS, DISTILL_CHUNK = 2, 30, 10  # 3 chunks a stage
DISTILL_LR = 1e-4  # the JAX CLI's default
AE_BATCH = 32  # train_autoencoder's default
# what the JAX CLI's eval prints with --kid and --wav (diffusestylegesture_tpu/cli/eval.py)
EVAL_KEYS = {"fgd", "embedding", "diversity_generated", "diversity_reference",
             "n_windows_generated", "n_windows_reference", "velocity_retention_min",
             "velocity_retention_mean", "velocity_clips_matched", "frozen_clips",
             "frozen_clip_stems", "kid_mean", "kid_std", "precision", "recall", "beat_alignment",
             "beat_alignment_clips", "beat_alignment_reference"}


def teacher_at_distillation_batch(dev, card, ckpt, cache):
    """The teacher's call at B = 300 through the kernels and through the plain
    ops, and each kernel at the shapes that call gives it against its plain
    version (A 1e-5, B 1e-4 per layer) and its library call."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from diffusestylegesture_torch.models.convert import load_reference_mdm
    from diffusestylegesture_torch.models.local_attention import local_attention_plain
    from diffusestylegesture_torch.models.mdm import MDMConfig
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.train import zeggs_cond_builder

    B, H, n, w, d, T, D, F_, heads = TRAIN_BATCH, 8, 88, 11, 32, 89, 256, 1024, 4
    mcfg = MDMConfig(audio_in_dim=cache.arrays["wavlm"].shape[-1])
    kernel = load_reference_mdm(ckpt, mcfg, device=dev)
    plain = load_reference_mdm(ckpt, dataclasses.replace(mcfg, impl="plain"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0, cond, _ = zeggs_cond_builder(cache.sample_batch(cache.arrays, gen, B))
    x = torch.randn(x0.shape, generator=gen, device=dev)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    res = {}
    with torch.no_grad():
        err = (kernel(x, t, cond) - plain(x, t, cond)).abs().max().item()
        check(err <= 1e-3, f"teacher B={B}: kernel path vs plain path {err}")
        # ~60 (kernel) and ~200 (plain) launches a call: 4 calls stay within the launch queue
        res["teacher_call"] = dict(kernel_ms=device_ms(lambda: kernel(x, t, cond), iters=4,
                                                       warmup=2),
                                   plain_ms=device_ms(lambda: plain(x, t, cond), iters=4,
                                                      warmup=2),
                                   kernel_vs_plain_max_abs_err=err)

        # kernel A: q = k = v, the (B, H, n, d) view of a (B, n, H·d) activation
        act = torch.randn(B, n, H * d, generator=gen, device=dev)
        view = act.view(B, n, H, d).transpose(1, 2)
        packed = view.reshape(B * H, n, d)
        merged = torch.empty(B, n, H * d, device=dev)
        out = merged.view(B, n, H, d).transpose(1, 2)
        full = torch.ones(B, n, dtype=torch.bool, device=dev)
        a_err = (la.local_attention(view, view, view, w, full, heads=H, out=out).reshape(
            B * H, n, d) - local_attention_plain(packed, packed, packed, w, full, heads=H)
        ).abs().max().item()
        check(a_err <= ATOL_LOCAL_ATTENTION, f"local_attention B={B}: err {a_err}")
        pos = torch.arange(n, device=dev)
        allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] >= (pos[:, None] // w - 1) * w)
        res["local_attention"] = dict(
            max_abs_err=a_err,
            ms=device_ms(lambda: la.local_attention(view, view, view, w, full, heads=H, out=out)),
            plain_ms=device_ms(lambda: local_attention_plain(packed, packed, packed, w, full,
                                                             heads=H), iters=10),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                packed, packed, packed, attn_mask=allowed), iters=10),
            bound=bound(2 * 4 * B * H * n * d + B * n, 2 * 2 * B * H * n * 2 * w * d))

        # kernel B: the teacher's eight layers on one activation
        h = torch.randn(B, T, D, generator=gen, device=dev)
        b_err = 0.0
        for layer in kernel.seqTransEncoder.layers:
            nxt = el.encoder_layer(h, layer)
            b_err = max(b_err, (nxt - layer(h)).abs().max().item())
            h = nxt
        check(b_err <= ATOL_ENCODER_LAYER, f"encoder_layer B={B}: err {b_err}")
        layer = kernel.seqTransEncoder.layers[0]
        ref = nn.TransformerEncoderLayer(D, heads, F_, dropout=0.0, activation="gelu",
                                         batch_first=True, norm_first=False).to(dev).eval()
        ref.load_state_dict(layer.state_dict())
        nbytes, flops = encoder_layer_cost(B, T, D, heads, F_)
        res["encoder_layer"] = dict(
            max_abs_err=b_err, ms=device_ms(lambda: el.encoder_layer(h, layer), iters=10),
            plain_ms=device_ms(lambda: layer(h), iters=10),
            library_ms=device_ms(lambda: ref(h), iters=10),
            bound=bound(nbytes, 3 * flops, TF32_FLOPS_PER_S),
            plan=el.describe_plan(B, T, D, heads, F_))
    print(f"teacher at B={B} [{card}]: {json.dumps(res)}")
    return res


def phase_distill_eval(dev, card, ctx, wav_path):
    import shutil

    import numpy as np
    import torch

    from diffusestylegesture_torch.cli import distill as distill_cli
    from diffusestylegesture_torch.cli import eval as eval_cli
    from diffusestylegesture_torch.cli import sample as sample_cli
    from diffusestylegesture_torch.data import ZeggsWindowDataset
    from diffusestylegesture_torch.data.device_cache import DeviceWindowCache
    from diffusestylegesture_torch.eval.embedding import (AEConfig, GestureAutoencoder,
                                                          make_autoencoder_step)
    from diffusestylegesture_torch.models.convert import load_reference_mdm
    from diffusestylegesture_torch.models.mdm import MDMConfig
    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.train import TrainConfig, TrainState, zeggs_cond_builder

    work, config, ckpt = ctx["work"], ctx["config"], ctx["checkpoint"]
    res = {}
    cwd = os.getcwd()
    os.chdir(work)  # configs/zeggs.yml's relative paths, as in phase 6
    try:
        # the distillation path, through the CLI: counters from 0 around the run
        la.launches = el.launches = el.launches_bf16 = 0
        out = distill_cli.main(["--config", config, "--teacher", ckpt, "--save_dir",
                                os.path.join(work, "distilled"), "--stages", str(DISTILL_STAGES),
                                "--steps_per_stage", str(DISTILL_STEPS), "--chunk",
                                str(DISTILL_CHUNK), "--batch_size", str(TRAIN_BATCH),
                                "--lr", str(DISTILL_LR), "--seed", "0"])
        counts = (la.launches, el.launches, el.launches_bf16)
        steps = sum(s["steps"] for s in out["stages"])
        check(steps == DISTILL_STAGES * DISTILL_STEPS, f"distill: {steps} steps")
        check(counts == (2 * steps, 16 * steps, 0),
              f"distill: launches {counts}, expected {(2 * steps, 16 * steps, 0)}")
        losses = [loss for s in out["stages"] for loss in s["losses"]]
        check(all(np.isfinite(losses)), f"distill: losses {losses}")
        # steady ms a step from the chunk boundaries, the first chunk (eager step,
        # capture) of each stage left out
        steady = [(b[-1][1] - b[0][1]) / (b[-1][0] - b[0][0]) * 1e3
                  for b in (s["boundaries"] for s in out["stages"])]
        res["cli"] = dict(stages=[dict(dir=os.path.basename(s["dir"]), steps=s["steps"],
                                       losses=s["losses"], capture_s=s["capture_seconds"])
                                  for s in out["stages"]],
                          local_attention_launches=counts[0], encoder_layer_launches=counts[1],
                          launches_per_step=(counts[0] / steps, counts[1] / steps),
                          steady_ms_per_step=steady)
        print(f"distill CLI [{card}]: {json.dumps(res['cli'])}")

        # the same stage-0 step in this process: captured against eager
        data = ZeggsWindowDataset(os.path.join("data", "zeggs_processed", "train"), None)
        cache = DeviceWindowCache.from_zeggs(data, dev)
        mcfg = MDMConfig(audio_in_dim=data.wavlm.shape[-1])
        sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=dev)

        teacher_pt = distill_cli.teacher_checkpoint(ckpt)

        def make():
            teacher = load_reference_mdm(teacher_pt, mcfg, device=dev)
            student = load_reference_mdm(teacher_pt, dataclasses.replace(mcfg, impl="plain"),
                                         device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            state, step = distill_cli.make_stage_step(student, teacher, sched, cache,
                                                      zeggs_cond_builder, TRAIN_BATCH,
                                                      DISTILL_LR, gen)
            return state, step, step, gen

        equal, eager_ms, captured_ms, run = captured_vs_eager(make)
        check(equal, "distill: the captured step differs from the eager step")
        res["step"] = dict(captured_equals_eager_3_steps=equal, eager_ms_per_step=eager_ms,
                           captured_ms_per_step=captured_ms, capture_s=run.capture_seconds)
        print(f"distill step, captured vs eager [{card}]: {json.dumps(res['step'])}")
        del run
        res["b300"] = teacher_at_distillation_batch(dev, card, teacher_pt, cache)

        # both students served through the kernels on their exact DDIM grids
        stems = os.path.splitext(os.path.basename(wav_path))[0]
        served = {}
        for stage in out["stages"]:
            name = os.path.basename(stage["dir"])
            grid = int(name.split("steps")[1])
            la.launches = el.launches = el.launches_bf16 = 0
            r = sample_cli.main(["--config", config, "--model_path", stage["dir"],
                                 "--audiowavlm_path", wav_path, "--save_dir",
                                 os.path.join(work, "served_" + name), "--seed", "123456"])
            counts = (la.launches, el.launches, el.launches_bf16)
            poses = r["poses"]
            check(len(r["paths"]) == 1 and os.path.getsize(r["paths"][0]) > 0,
                  f"{name}: no BVH written")
            check(poses.shape == (1, 3 * 80 - 8, 1141) and bool(np.isfinite(poses).all()),
                  f"{name}: poses {poses.shape}, finite {np.isfinite(poses).all()}")
            check(counts == (3 * grid, 24 * grid, 0),
                  f"{name}: launches {counts}, expected {(3 * grid, 24 * grid, 0)}")
            served[name] = dict(local_attention_launches=counts[0],
                                encoder_layer_launches=counts[1],
                                generate_s=r["generate_seconds"], poses=poses[0])
        res["served"] = {k: {kk: vv for kk, vv in v.items() if kk != "poses"}
                         for k, v in served.items()}
        print(f"distilled students served [{card}]: {json.dumps(res['served'])}")

        # the last student's poses scored against the teacher's dpmpp5 poses
        # (phase 6) for the same seeded audio, paired by stem
        ev = os.path.join(work, "eval")
        for sub in ("gen", "ref", "wav"):
            os.makedirs(os.path.join(ev, sub))
        np.save(os.path.join(ev, "gen", stems + ".npy"), served[name]["poses"])
        np.save(os.path.join(ev, "ref", stems + ".npy"), ctx["teacher_poses"])
        shutil.copy(wav_path, os.path.join(ev, "wav", stems + ".wav"))
        t0 = time.perf_counter()
        scores = eval_cli.main(["--generated", os.path.join(ev, "gen"), "--reference",
                                os.path.join(ev, "ref"), "--wav", os.path.join(ev, "wav"),
                                "--embedding", "autoencoder", "--kid", "--stride", "2",
                                "--ae_latent", "16", "--ae_steps", "200"])
        res["eval_s"] = time.perf_counter() - t0
        check(set(scores) == EVAL_KEYS, f"eval keys {sorted(set(scores) ^ EVAL_KEYS)} differ")
        check(np.isfinite(scores["fgd"]) and scores["velocity_clips_matched"] == 1,
              f"eval: {scores}")
        res["eval"] = scores

        # the autoencoder's step at cli/eval's widths: captured against eager
        windows = eval_cli.windowed_features({"ref": ctx["teacher_poses"]}, 40, 2).reshape(
            -1, 40, 1141)
        ae_data = torch.as_tensor(windows, device=dev)

        def make_ae():
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                model = GestureAutoencoder(AEConfig(latent=16)).to(dev)
            state = TrainState(model, TrainConfig(lr=1e-3))
            step = make_autoencoder_step(state, ae_data, AE_BATCH)
            gen = torch.Generator(device=dev).manual_seed(0)
            return state, lambda: step(gen), lambda: step(gen), gen

        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            equal, eager_ms, captured_ms, run = captured_vs_eager(make_ae, steps=50)
        check(equal, "autoencoder: the captured step differs from the eager step")
        res["autoencoder_step"] = dict(captured_equals_eager_3_steps=equal,
                                       eager_ms_per_step=eager_ms,
                                       captured_ms_per_step=captured_ms,
                                       capture_s=run.capture_seconds, batch=AE_BATCH,
                                       windows=len(windows))
        print(f"autoencoder step, captured vs eager [{card}]: "
              f"{json.dumps(res['autoencoder_step'])}")
    finally:
        os.chdir(cwd)
    return res


# ---- phase 8 --------------------------------------------------------------------


BEAT_TWH_SECONDS = 16.0  # 479 frames at 30 fps: 4 windows of 120
BEAT_TWH_WORDS = ("hello", "world", "gesture", "big motion", "speech", "#laugh#", "hands",
                  "unknown")
MOTION_DIMS = {"BEAT": 684, "TWH": 744}  # the v0 position blocks
# (run, dataset, model, live wav + tsv or the npy, sampler, steps, --serve_fast)
BEAT_TWH_RUNS = (
    ("twh_dsg+_ddpm1000", "TWH", "DiffuseStyleGesture+", True, "ddpm", 1000, False),
    ("twh_dsg+_dpmpp5", "TWH", "DiffuseStyleGesture+", True, "dpmpp", 5, False),
    ("twh_dsg+_dpmpp5_serve_fast", "TWH", "DiffuseStyleGesture+", True, "dpmpp", 5, True),
    ("twh_dsg++_dpmpp5", "TWH", "DiffuseStyleGesture++", False, "dpmpp", 5, False),
    ("beat_dsg_dpmpp5", "BEAT", "DiffuseStyleGesture", False, "dpmpp", 5, False),
)


def mode_flags(sampler, steps, bf16=False):
    """The CLI flags of a mode: the yaml's 1000-step schedule or a respaced one."""
    flags = [] if steps == 1000 else ["--respace", str(steps)]
    return ["--sampler", sampler] + flags + (["--serve_fast"] if bf16 else [])


def write_beat_twh_run(tmp):
    """Seeded inputs of phase 8 under `tmp`/beat_twh: a wav of BEAT_TWH_SECONDS
    (a gliding voiced tone, amplitude-modulated, with noise), its word timings
    (a word every 0.45 s), a `.vec` file of 300-d vectors for them, and per
    dataset a yaml, stats and a raw seed clip; and the three models' random
    weights in reference layout at the published widths (TWH + and ++, BEAT
    DiffuseStyleGesture). Returns the paths."""
    import numpy as np
    import torch
    import yaml
    from scipy.io import wavfile

    from diffusestylegesture_torch.cli.sample_beat import mdm_plus_config
    from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
    from diffusestylegesture_torch.models.mdm_plus import MDMPlus

    d = os.path.join(tmp, "beat_twh")
    os.makedirs(d)
    rng = np.random.default_rng(SEED + 8)
    sr = 16000
    t = np.arange(int(sr * BEAT_TWH_SECONDS)) / sr
    phase = 2 * np.pi * np.cumsum(140 + 30 * np.sin(2 * np.pi * 0.3 * t)) / sr
    wav = (0.5 * (1 + np.sin(2 * np.pi * 1.7 * t)) * (0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase))
           + 0.02 * rng.standard_normal(t.shape))
    files = {"wav": os.path.join(d, "clip.wav"), "tsv": os.path.join(d, "clip.tsv"),
             "vec": os.path.join(d, "words.vec")}
    wavfile.write(files["wav"], sr, (wav * 12000).astype(np.int16))
    with open(files["tsv"], "w") as f:
        for i, start in enumerate(np.arange(0.2, BEAT_TWH_SECONDS - 0.5, 0.45)):
            f.write(f"{start:.2f}\t{start + 0.35:.2f}\t"
                    f"{BEAT_TWH_WORDS[i % len(BEAT_TWH_WORDS)]}\n")
    vocab = sorted({w for words in BEAT_TWH_WORDS[:-1] for w in words.strip("#").split()})
    with open(files["vec"], "w") as f:
        f.write(f"{len(vocab)} 300\n")
        for w in vocab:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(300)) + "\n")
    for dataset, name, extra in (("TWH", "DiffuseStyleGesture+", {}),
                                 ("BEAT", "DiffuseStyleGesture",
                                  dict(latent_dim=384, audio_feat_dim_latent=96))):
        cfg = dict(dataset=dataset, name=name, version="v0", n_poses=150, n_seed=30,
                   cond_mask_prob=0.1, diffusion_steps=1000, noise_schedule="cosine", **extra)
        dim = MOTION_DIMS[dataset]
        paths = {k: os.path.join(d, f"{dataset}_{k}") for k in ("yml", "mean.npy", "std.npy",
                                                                 "seed.npy")}
        with open(paths["yml"], "w") as f:
            yaml.safe_dump(cfg, f)
        np.save(paths["mean.npy"], rng.standard_normal(dim).astype(np.float32))
        np.save(paths["std.npy"], (0.5 + rng.random(dim)).astype(np.float32))
        np.save(paths["seed.npy"], rng.standard_normal((40, dim)).astype(np.float32))
        files[dataset] = paths
    for dataset, name in (("TWH", "DiffuseStyleGesture+"), ("TWH", "DiffuseStyleGesture++"),
                          ("BEAT", "DiffuseStyleGesture")):
        cfg = apply_beat_twh_derivations(load_yaml_config(files[dataset]["yml"], {"name": name}))
        torch.manual_seed(SEED)
        files[name, dataset] = os.path.join(d, f"{dataset}_{name}.pt")
        torch.save(MDMPlus(mdm_plus_config(cfg)).state_dict(), files[name, dataset])
    return files


def beat_twh_sampler(dev, cfg, variant, sampler, steps, graphs=None):
    """The CLI's engine for a derived yaml `cfg`, on the yaml's 1000-step
    schedule or a respaced one."""
    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.sample import BeatEngineConfig, BeatTwhSampler

    betas = D.named_beta_schedule("cosine", 1000)
    sched = (D.Schedule.create(betas, device=dev) if steps == 1000 else
             D.spaced_schedule(betas, D.space_timesteps(1000, f"ddim{steps}"), device=dev))
    return BeatTwhSampler(
        lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond), sched,
        BeatEngineConfig(njoints=cfg.njoints, audio_dim=cfg.audio_feature_dim, variant=variant,
                         sampler=sampler),
        device=dev, graphs=graphs)


def phase_beat_twh(dev, tmp, card, wavlm_pt):
    import numpy as np
    import torch

    from diffusestylegesture_torch.cli import sample_beat as beat_cli
    from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
    from diffusestylegesture_torch.data import load_wav_16k
    from diffusestylegesture_torch.models.convert import (load_reference_mdm_plus,
                                                          load_wavlm_checkpoint)
    from diffusestylegesture_torch.models.wavlm import make_twh_wavlm_fn
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.sample import prepare_seed_gesture
    from diffusestylegesture_torch.utils.graphs import GraphSet

    t0 = time.perf_counter()
    files = write_beat_twh_run(tmp)
    print(f"BEAT/TWH inputs and full-width checkpoints written in "
          f"{time.perf_counter() - t0:.1f} s")
    cfgs = {(ds, name): apply_beat_twh_derivations(load_yaml_config(files[ds]["yml"],
                                                                    {"name": name}))
            for ds, name in (("TWH", "DiffuseStyleGesture+"), ("TWH", "DiffuseStyleGesture++"),
                             ("BEAT", "DiffuseStyleGesture"))}
    twh = cfgs["TWH", "DiffuseStyleGesture+"]

    # the live features once in this process (host numpy + WavLM-Large on the
    # card): the npy of the runs that take one, and the in-process runs' input
    textaudio, features_s, wavlm_s = beat_cli.live_features(
        twh, files["wav"], files["tsv"], files["vec"], wavlm_pt, dev)
    real_n = textaudio.shape[0]
    windows = -(-real_n // 120)
    check(windows >= 3, f"BEAT/TWH clip gives {windows} windows")
    npys = {"TWH": os.path.join(tmp, "beat_twh", "TWH_textaudio.npy"),
            "BEAT": os.path.join(tmp, "beat_twh", "BEAT_textaudio.npy")}
    np.save(npys["TWH"], textaudio)
    # BEAT's 301-d text block: the 300 word-vector dims and the silence flag (no laughter)
    np.save(npys["BEAT"], np.concatenate([textaudio[:, :1133 + 300], textaudio[:, -1:]], 1))
    results = dict(real_n=real_n, windows=windows, features_s=features_s, wavlm_s=wavlm_s)

    # each path through the CLI, on the graph engine: counters from 0 around the run
    motions = {}
    for run, ds, name, live, sampler, steps, bf16 in BEAT_TWH_RUNS:
        paths = files[ds]
        inputs = (["--wav", files["wav"], "--tsv", files["tsv"], "--word_vectors", files["vec"],
                   "--wavlm_path", wavlm_pt] if live else ["--textaudio_npy", npys[ds]])
        la.launches = el.launches = el.launches_bf16 = 0
        res, wall = timed(lambda: beat_cli.main(
            ["--config", paths["yml"], "--name", name, "--model_path", files[name, ds],
             "--seed_gesture_npy", paths["seed.npy"], "--mean_npy", paths["mean.npy"],
             "--std_npy", paths["std.npy"], "--speaker", "1", "--seed", "123456",
             "--save_dir", os.path.join(tmp, "beat_twh", "out_" + run)] + inputs
            + mode_flags(sampler, steps, bf16)))
        counts = (la.launches, el.launches, el.launches_bf16)
        calls = windows * steps
        motion = motions[run] = res["motion"]
        check(motion.shape == (1, real_n, MOTION_DIMS[ds]), f"{run}: motion {motion.shape}")
        check(bool(np.isfinite(motion).all()), f"{run}: non-finite motion")
        check(np.array_equal(np.load(res["path"]), motion[0]), f"{run}: the npy differs")
        expected = (calls, 0, 8 * calls) if bf16 else (calls, 8 * calls, 0)
        check(counts == expected, f"{run}: launches {counts}, expected {expected}")
        gen_s = res["generate_seconds"]
        results[run] = dict(denoiser_calls=calls, local_attention_launches=counts[0],
                            encoder_layer_launches=counts[1],
                            encoder_layer_bf16_launches=counts[2], generate_s=gen_s,
                            capture_s=res["capture_seconds"], cli_wall_s=wall,
                            features_s=res["features_seconds"],
                            wavlm_s=res["wavlm_seconds"], frames=real_n,
                            frames_per_s=real_n / gen_s)
        print(f"beat_twh {run} (CLI, graphs, capture included) [{card}]: "
              f"{json.dumps(results[run])}")

    # in this process: graph against eager (bitwise, and timed), the npy runs
    # against the CLI's motion
    models = {(ds, name, bf16): load_reference_mdm_plus(
        files[name, ds], beat_cli.mdm_plus_config(cfgs[ds, name], bf16), device=dev)
        for _, ds, name, _, _, _, bf16 in BEAT_TWH_RUNS}
    beat_ta = np.load(npys["BEAT"])

    def inputs(ds, name):
        cfg = cfgs[ds, name]
        mean, std = (np.load(files[ds][k]) for k in ("mean.npy", "std.npy"))
        seed = prepare_seed_gesture(np.load(files[ds]["seed.npy"])[:32], mean, std)
        return cfg, (textaudio if ds == "TWH" else beat_ta, seed,
                     np.eye(cfg.style_dim, dtype=np.float32)[[1]]), mean, std, seed

    for run, ds, name, live, sampler, steps, bf16 in BEAT_TWH_RUNS:
        model = models[ds, name, bf16]
        cfg, (ta, seed, sty), mean, std, _ = inputs(ds, name)
        variant = beat_cli.VARIANTS[name]
        sl = seed if variant == "attention5" else None
        out = {}
        for path, flag in (("graph", None), ("eager", False)):
            s = beat_twh_sampler(dev, cfg, variant, sampler, steps, flag)
            if flag is None:  # capture first, then time a call that replays
                s.generate(model, ta, seed, sty, torch.Generator(device=dev).manual_seed(123456),
                           mean, std, seed_last=sl)
            out[path] = timed(lambda: s.generate(
                model, ta, seed, sty, torch.Generator(device=dev).manual_seed(123456),
                mean, std, seed_last=sl))
        same = bool(np.array_equal(out["graph"][0], out["eager"][0]))
        check(same, f"{run}: graph and eager motion differ "
                    f"(max {np.abs(out['graph'][0] - out['eager'][0]).max()})")
        # the live runs' CLI computed its own features (its WavLM call may round
        # otherwise): held within the end-to-end bar; the npy runs bitwise
        cli_err = float(np.abs(out["graph"][0] - motions[run]).max())
        if live:
            check(cli_err <= E2E_REL * max(float(np.abs(motions[run]).mean()), 1.0),
                  f"{run}: the CLI's motion is {cli_err} from the same run in this process")
        else:
            check(cli_err == 0.0, f"{run}: the CLI's motion differs from this process's")
        results[run].update(graph_generate_s=out["graph"][1],
                            graph_frames_per_s=real_n / out["graph"][1],
                            eager_generate_s=out["eager"][1],
                            eager_frames_per_s=real_n / out["eager"][1], graph_equals_eager=same,
                            cli_vs_in_process_max_abs=cli_err)
        print(f"beat_twh {run} in one process [{card}]: graph {out['graph'][1]:.4f} s "
              f"({real_n / out['graph'][1]:.1f} frames/s), eager {out['eager'][1]:.4f} s "
              f"({real_n / out['eager'][1]:.1f} frames/s), equal {same}, CLI diff {cli_err:.3e}")

    # TWH +: serve_fast against float32 and the kernel path against the plain
    # path, dpmpp5 on the same injected noise
    cfg, (ta, seed, sty), mean, std, _ = inputs("TWH", "DiffuseStyleGesture+")
    noise = np.random.default_rng(SEED + 9).standard_normal(
        (windows, 1, cfg.njoints, 1, 150)).astype(np.float32)
    kernel = models["TWH", "DiffuseStyleGesture+", False]
    variants = {"f32": kernel, "bf16": models["TWH", "DiffuseStyleGesture+", True],
                "plain": load_reference_mdm_plus(
                    files["DiffuseStyleGesture+", "TWH"],
                    dataclasses.replace(kernel.cfg, impl="plain"), device=dev)}
    poses = {name: beat_twh_sampler(dev, cfg, "attention4", "dpmpp", 5).generate(
        model, ta, seed, sty, torch.Generator(device=dev).manual_seed(7), mean, std,
        noise_windows=noise) for name, model in variants.items()}
    bf16_err = float(np.sqrt(np.mean((poses["bf16"] - poses["f32"]) ** 2)) / poses["f32"].std())
    scale = float(np.abs(poses["plain"]).mean())
    err = float(np.abs(poses["f32"] - poses["plain"]).max())
    print(f"TWH serve_fast vs float32 (dpmpp5, same noise): RMS/std {bf16_err:.3e} (bar "
          f"{BF16_TOL}); kernel path vs plain path: max abs err {err:.3e}, scale {scale:.3f}")
    check(bf16_err < BF16_TOL, f"TWH serve_fast: RMS/std {bf16_err} >= {BF16_TOL}")
    check(err <= E2E_REL * max(scale, 1.0), f"TWH kernel vs plain path: {err} > {E2E_REL} rel")

    # WavLM-Large over the clip's 5 s chunks, replayed from a graph; one TWH
    # denoiser call eager, replayed from a graph and through the plain path
    _, wavlm = load_wavlm_checkpoint(wavlm_pt, device=dev)
    wav = torch.as_tensor(load_wav_16k(files["wav"]), device=dev)
    step = {}
    with torch.inference_mode():
        encoder, _ = GraphSet(dev).capture(lambda: make_twh_wavlm_fn()(wavlm, wav))
        wavlm_ms = device_ms(encoder.replay, iters=5, warmup=1)
        x = torch.randn(1, cfg.njoints, 1, 150, device=dev)
        cond = {"style": torch.as_tensor(sty, device=dev),
                "seed": torch.as_tensor(seed.T[None, :, None, :], device=dev),
                "audio": torch.as_tensor(ta[None, :120], device=dev),
                "mask_local": torch.ones(1, 150, dtype=torch.bool, device=dev)}
        tt = torch.tensor([500], device=dev)
        out = torch.empty_like(x)
        replay, _ = GraphSet(dev).capture(lambda: out.copy_(kernel(x, tt, cond)))
        replay.launches = (0,) * len(replay.launches)  # timing calls are not main-path launches
        for name, fn, iters in (("kernel", lambda: kernel(x, tt, cond), 4),
                                ("graph_replay", replay.replay, 40),
                                ("plain", lambda: variants["plain"](x, tt, cond), 4)):
            step[name + "_device_ms"] = device_ms(fn, iters=iters, warmup=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            step[name + "_wall_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        check(torch.equal(out.clone(), kernel(x, tt, cond)),
              "a replayed TWH denoiser call differs from the eager call")
    results.update(kernel_vs_plain_max_abs_err=err, kernel_vs_plain_scale=scale,
                   serve_fast_rms_over_std=bf16_err, wavlm_large_chunks=len(wav) // 80000 + 1,
                   wavlm_large_clip_ms=wavlm_ms, twh_denoiser_call_b1=step)
    print(f"TWH denoiser call B=1 [{card}]: {json.dumps(step)}; WavLM-Large over the clip's "
          f"{results['wavlm_large_chunks']} chunks {wavlm_ms:.3f} ms f32; host features "
          f"{features_s:.2f} s")
    return results


# ---- phase 9 --------------------------------------------------------------------


TWH_TRAIN_CLIPS = tuple(f"trn_2023_v0_{i:03d}_main-agent" for i in range(4))
BEAT_TRAIN_CLIPS = ("1_wayne_0_1_1", "2_scott_0_1_1")
TRAIN_CLIP_SECONDS = 60
BEAT_TWH_BATCH = 350  # configs/beat_twh.yml's
BEAT_TWH_STEPS = 30
BEAT_TWH_RESUME_AT = 20
BEAT_TWH_SHORT_STEPS = 10  # the ++ and BEAT runs: every cond builder on the card
SERVE_FRAMES = 479  # 4 windows of 120: kernel A 20 and kernel B 160 launches in dpmpp5
WIDTHS = {"TWH": (744, 302), "BEAT": (684, 301)}


def twh_skeleton():
    """{bone: parent} over the 62 TWH bones: legs and spine from b_root, arms
    from b_spine3, each finger chain from its wrist, the rest from the bone
    listed before."""
    from diffusestylegesture_torch.motion.pipeline import TWH_BONE_NAMES

    parents = {"body_world": None}
    for prev, name in zip(TWH_BONE_NAMES, TWH_BONE_NAMES[1:]):
        if name.endswith(("upleg", "spine0")):
            parents[name] = "b_root"
        elif name.endswith("shoulder"):
            parents[name] = "b_spine3"
        elif name.endswith(("thumb0", "index1", "middle1", "ring1", "pinky1")):
            parents[name] = f"b_{name[2]}_wrist"
        else:
            parents[name] = prev
    return parents


def smooth_channels(rng, T, fps, n, amplitude):
    """(T, n) sinusoids of random frequency (0.1-1.5 Hz) and phase."""
    import numpy as np

    t = np.arange(T)[:, None] / fps
    return rng.uniform(0.2, 1.0, (1, n)) * amplitude * np.sin(
        2 * np.pi * rng.uniform(0.1, 1.5, (1, n)) * t + rng.uniform(0, 2 * np.pi, (1, n)))


def write_beat_twh_train_clips(work):
    """Seeded BEAT and TWH training sources under `work`/{twh,beat}_raw: per
    clip a 16 kHz wav of TRAIN_CLIP_SECONDS (a gliding voiced tone, amplitude
    modulated, with noise), its word timings (a word every 0.45 s) and a BVH
    written by the port's `write_bvh_channels`: TWH at 30 fps with the 62
    bones of `TWH_BONE_NAMES`, 6 channels each (744 features); BEAT at 120
    fps, Hips (6 channels) + the 74 `BEAT_TARGET_JOINTS` + one more joint
    (684 features). A GENEA metadata csv gives the TWH clips speakers 3 and 9.
    Returns {dataset: source dir} and the seconds of BVH writing."""
    import numpy as np
    from scipy.io import wavfile

    from diffusestylegesture_torch.motion import pipeline as P

    rng = np.random.default_rng(SEED + 90)
    sr = 16000
    srcs = {}
    bvh_write_s = 0.0
    for dataset, names, fps in (("TWH", TWH_TRAIN_CLIPS, 30), ("BEAT", BEAT_TRAIN_CLIPS, 120)):
        src = srcs[dataset] = os.path.join(work, dataset.lower() + "_raw")
        os.makedirs(src)
        T = TRAIN_CLIP_SECONDS * fps
        if dataset == "TWH":
            parents = twh_skeleton()
            chans = ["Xposition", "Yposition", "Zposition", "Zrotation", "Xrotation", "Yrotation"]
            channels = {j: list(chans) for j in parents}
            root = "body_world"
        else:
            joints = ["Hips"] + list(P.BEAT_TARGET_JOINTS) + ["Extra1"]
            parents = {"Hips": None, **dict(zip(joints[1:], joints))}
            channels = {j: ["Xrotation", "Yrotation", "Zrotation"] for j in joints}
            channels["Hips"] = ["Xposition", "Yposition", "Zposition"] + channels["Hips"]
            root = "Hips"
        joints = list(parents)
        for leaf in [j for j in joints if j not in set(parents.values())]:
            parents[leaf + "_Nub"], channels[leaf + "_Nub"] = leaf, []
        columns = [f"{j}_{c}" for j in joints for c in channels[j]]
        for i, name in enumerate(names):
            t = np.arange(TRAIN_CLIP_SECONDS * sr) / sr
            f0 = 120 + 40 * i + 30 * np.sin(2 * np.pi * 0.3 * t)
            phase = 2 * np.pi * np.cumsum(f0) / sr
            wav = (0.5 * (1 + np.sin(2 * np.pi * 1.7 * t)) * (0.3 * np.sin(phase)
                                                             + 0.1 * np.sin(2 * phase))
                   + 0.02 * rng.standard_normal(t.shape))
            wavfile.write(os.path.join(src, name + ".wav"), sr, (wav * 12000).astype(np.int16))
            with open(os.path.join(src, name + ".tsv"), "w") as f:
                for k, start in enumerate(np.arange(0.2, TRAIN_CLIP_SECONDS - 0.5, 0.45)):
                    f.write(f"{start:.2f}\t{start + 0.35:.2f}\t"
                            f"{BEAT_TWH_WORDS[(k + i) % len(BEAT_TWH_WORDS)]}\n")
            offsets = {n: rng.uniform(-10, 10, 3).astype(np.float32) for n in parents}
            values = smooth_channels(rng, T, fps, len(columns), 40.0)
            for c, col in enumerate(columns):
                joint, chan = col.rsplit("_", 1)
                if chan.endswith("position"):  # bone offsets, the root wandering
                    axis = "XYZ".index(chan[0])
                    values[:, c] = offsets[joint][axis] + (
                        values[:, c] if joint == root else 0.0)
            t0 = time.perf_counter()
            P.write_bvh_channels(P.ChannelData(list(parents), dict(parents), offsets, channels,
                                               columns, values, 1.0 / fps, root),
                                 os.path.join(src, name + ".bvh"))
            bvh_write_s += time.perf_counter() - t0
    with open(os.path.join(work, "metadata.csv"), "w") as f:
        f.write("prefix,main-agent_id,main-agent_has_finger,interloctr_id,interloctr_has_finger\n")
        for i, name in enumerate(TWH_TRAIN_CLIPS):
            f.write(f"{name[:-len('_main-agent')]},{3 if i % 2 else 9},finger_incl,1,"
                    "finger_incl\n")
    return srcs, bvh_write_s


def mdm_plus_flops_per_window(T=150, njoints=2232, D=512, F=1024, layers=8, n_seed=30,
                              audio=1435, audio_d=128, window=15, variant=4):
    """Forward FLOPs of the MDMPlus for one window, from its shapes (TWH +
    by default)."""
    t_audio = T - n_seed * (variant - 3)
    trunk = layers * (2 * (T + 1) * (4 * D * D + 2 * D * F) + 2 * 2 * (T + 1) ** 2 * D)
    pose = 2 * 2 * T * njoints * D                             # input_process, output_process
    cond = (2 * t_audio * audio * audio_d + 2 * T * (2 * D + audio_d) * D  # audio, input_process2
            + 2 * 2 * D * D)                                   # timestep MLP
    seed = (2 * njoints * n_seed * (D - 64) if variant == 3
            else 2 * n_seed * njoints * audio_d * (variant - 3))   # seed (and seed_last)
    local = 2 * 2 * T * 2 * window * D
    return trunk + pose + cond + seed + local


def beat_twh_yaml(work, dataset):
    """configs/beat_twh.yml as published, `h5file` pointing at the store that
    `cli.prepare_data` wrote (the port's .npz) under `work`."""
    import yaml

    with open(os.path.join(HERE, "configs", "beat_twh.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(dataset=dataset, h5file=f"./data/{dataset}_v0.npz")
    path = os.path.join(work, f"beat_twh_{dataset}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_beat_twh_training(dev, tmp, card, wavlm_pt, vec_path):
    import numpy as np
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import prepare_data, sample_beat as beat_cli
    from diffusestylegesture_torch.cli import train as train_cli
    from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
    from diffusestylegesture_torch.data import SpeechGestureDataset, gesture_statistics
    from diffusestylegesture_torch.data.device_cache import (DeviceWindowCache,
                                                             make_device_data_train_step)
    from diffusestylegesture_torch.data.h5_loader import read_store
    from diffusestylegesture_torch.models.mdm_plus import MDMPlus
    from diffusestylegesture_torch.motion import pipeline as P
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.train import (TrainConfig, TrainState, make_beat_cond_builder,
                                                 make_train_step)

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "beat_twh_train")
    os.makedirs(os.path.join(work, "data"))
    res = {}
    cwd = os.getcwd()
    os.chdir(work)  # the yaml's relative paths resolve under `work`
    try:
        t0 = time.perf_counter()
        srcs, bvh_write_s = write_beat_twh_train_clips(work)
        res["write_clips_s"], res["bvh_write_s"] = time.perf_counter() - t0, bvh_write_s

        # 1. data preparation: host features in 4 spawned workers, WavLM-Large here
        prep = {}
        for dataset, extra in (("TWH", ["--metadata", os.path.join(work, "metadata.csv"),
                                        "--num_speakers", "17"]),
                               ("BEAT", ["--num_speakers", "2"])):
            target = os.path.join("data", f"{dataset}_v0.npz")
            t0 = time.perf_counter()
            out = prepare_data.main(["--dataset", dataset, "--source", srcs[dataset], "--target",
                                     target, "--wavlm_path", wavlm_pt, "--word_vectors",
                                     vec_path, "--workers", "4"] + extra)
            wall = time.perf_counter() - t0
            motion_dim, text_dim = WIDTHS[dataset]
            for clip in out["clips"]:
                n = len(clip["gesture"])
                check(clip["gesture"].shape == (n, motion_dim) and clip["audio"].shape ==
                      (n, 1133) and clip["text"].shape == (n, text_dim),
                      f"prepare {dataset}: widths {[v.shape for v in clip.values()]}")
                check(n >= TRAIN_CLIP_SECONDS * 30 - 3, f"prepare {dataset}: {n} frames")
            stats = [np.load(os.path.join("data", f"{dataset}_v0_{s}.npy")).shape
                     for s in ("mean", "std")]
            check(stats == [(motion_dim,)] * 2, f"prepare {dataset}: stats {stats}")
            prep[dataset] = dict(clips=len(out["clips"]), frames=sum(len(c["gesture"])
                                                                     for c in out["clips"]),
                                 widths=dict(gesture=motion_dim, audio=1133, text=text_dim),
                                 stats_shape=list(stats[0]), wall_s=wall,
                                 wavlm_large_ms=out["seconds"]["wavlm"] * 1e3,
                                 **{k + "_s": v for k, v in out["seconds"].items()
                                    if k != "wavlm"})
            print(f"prepare {dataset} [{card}]: {json.dumps(prep[dataset])}")
        res["prepare"] = prep

        # 2. training through the CLI, the published batch and window
        twh_yml, beat_yml = beat_twh_yaml(work, "TWH"), beat_twh_yaml(work, "BEAT")
        runs = {}
        for mode, dataset, name, flags, steps, log in (
                ("twh+_f32", "TWH", "DiffuseStyleGesture+", [], BEAT_TWH_RESUME_AT, 10),
                ("twh+_f32", "TWH", "DiffuseStyleGesture+", [], 2 * BEAT_TWH_RESUME_AT, 10),
                ("twh+_bf16_device_cache", "TWH", "DiffuseStyleGesture+",
                 ["--bf16", "--device_cache"], BEAT_TWH_STEPS, 10),
                ("twh++_f32", "TWH", "DiffuseStyleGesture++", [], BEAT_TWH_SHORT_STEPS, 5),
                ("beat_dsg_f32", "BEAT", "DiffuseStyleGesture", [], BEAT_TWH_SHORT_STEPS, 5)):
            config = twh_yml if dataset == "TWH" else beat_yml
            la.launches = el.launches = el.launches_bf16 = 0
            torch.cuda.reset_peak_memory_stats(dev)
            out = train_cli.main(["--config", config, "--name", name, "--num_steps", str(steps),
                                  "--save_dir", os.path.join(work, "out_" + mode),
                                  "--log_interval", str(log), "--seed", "0"] + flags)
            counts = (la.launches, el.launches, el.launches_bf16)
            loop, state = out["loop"], out["state"]
            check(counts == (0, 0, 0), f"train {mode}: kernels launched while training {counts}")
            check(state.step == steps, f"train {mode}: ended at step {state.step}, not {steps}")
            losses = [d["loss"] for d in loop.logged]
            check(len(losses) >= 2 and all(np.isfinite(losses)), f"train {mode}: losses {losses}")
            check(bool(torch.isfinite(state.params.data).all()),
                  f"train {mode}: non-finite weights")
            check(state.params.data.dtype == state.optimizer.mu.dtype == state.optimizer.nu.dtype
                  == torch.float32, f"train {mode}: master weights or moments not float32")
            first = mode not in runs
            r = runs.setdefault(mode, dict(loops=[], losses=[], peak_bytes=0,
                                           cfg=apply_beat_twh_derivations(load_yaml_config(
                                               config, {"name": name}))))
            r["loops"].append(loop)
            r["losses"] += losses
            r["peak_bytes"] = max(r["peak_bytes"], torch.cuda.max_memory_allocated(dev))
            if mode == "twh+_f32" and not first:
                check(loop.resume_step == BEAT_TWH_RESUME_AT, f"resumed at {loop.resume_step}")
            print(f"train {mode} [{card}]: step {state.step}, losses {losses}, "
                  f"ms/step by window {[d['ms_per_step'] for d in loop.logged]}")
        modes = {}
        for mode, r in runs.items():
            cfg = r["cfg"]
            flops = 3 * BEAT_TWH_BATCH * mdm_plus_flops_per_window(
                njoints=cfg.njoints, D=cfg.latent_dim, F=cfg.get("ff_size", 1024),
                layers=cfg.get("num_layers", 8), audio=cfg.audio_feature_dim,
                audio_d=cfg.audio_feat_dim_latent,
                variant=int(cfg.cond_mode[len("cross_local_attention")]))
            ms = steady_ms(r["loops"])
            modes[mode] = dict(ms_per_step=ms, windows_per_s=BEAT_TWH_BATCH / ms * 1e3,
                               peak_memory_bytes=r["peak_bytes"], model_flops_per_step=flops,
                               f32_peak_share=flops / (ms / 1e3) / F32_FLOPS_PER_S,
                               bf16_peak_share=flops / (ms / 1e3) / BF16_FLOPS_PER_S,
                               first_loss=r["losses"][0], last_loss=r["losses"][-1],
                               steps=r["loops"][-1].state.step, cond_mode=cfg.cond_mode)
        res.update(modes=modes, batch=BEAT_TWH_BATCH, n_poses=150,
                   resumed=dict(stopped_at=BEAT_TWH_RESUME_AT,
                                ended_at=runs["twh+_f32"]["loops"][-1].state.step))

        # 3. the device-cache step captured against eager; gradients, dtypes, a
        # falling loss on one batch, on fresh full-width TWH + models
        twh = runs["twh+_f32"]["cfg"]
        mean, std = gesture_statistics(twh.h5file)
        cache = DeviceWindowCache.from_beat_twh(
            SpeechGestureDataset(twh.h5file, mean, std, n_poses=twh.n_poses), dev)
        builder = make_beat_cond_builder(twh.cond_mode, twh.n_seed)
        sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=dev)
        mcfg = dataclasses.replace(beat_cli.mdm_plus_config(twh), impl="plain")

        def fresh_model():
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                return MDMPlus(mcfg).to(dev)

        captured = {}
        for mode, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = TrainConfig(lr=3e-5, compute_dtype=dtype)  # configs/beat_twh.yml's optimizer
            step = make_device_data_train_step(sched, cfg, builder, BEAT_TWH_BATCH,
                                               cache.sample_fn)

            def make():
                state = TrainState(fresh_model(), cfg, 1000)
                gen = torch.Generator(device=dev).manual_seed(0)
                return (state, lambda: step(state, gen, cache.arrays),
                        lambda: step.device_step(state, gen, cache.arrays), gen)

            la.launches = el.launches = el.launches_bf16 = 0
            equal, eager_ms, captured_ms, run = captured_vs_eager(make)
            check((la.launches, el.launches, el.launches_bf16) == (0, 0, 0),
                  f"captured train {mode}: kernels launched")
            check(equal, f"BEAT/TWH train {mode}: the captured step differs from the eager step")
            captured[mode] = dict(captured_equals_eager_3_steps=equal,
                                  eager_ms_per_step=eager_ms, captured_ms_per_step=captured_ms,
                                  captured_windows_per_s=[BEAT_TWH_BATCH / ms * 1e3
                                                          for ms in captured_ms],
                                  capture_s=run.capture_seconds)
            print(f"BEAT/TWH train {mode} device cache, captured vs eager [{card}]: "
                  f"{json.dumps(captured[mode])}")
            del run
        res["captured_vs_eager"] = captured

        fixed = cache.sample_fn(cache.arrays, torch.Generator(device=dev).manual_seed(1),
                                BEAT_TWH_BATCH)
        cfg = TrainConfig(compute_dtype="bfloat16", ema_rate=0.9999)
        state = TrainState(fresh_model(), cfg, 1000)
        make_train_step(sched, cfg, builder)(state, fixed,
                                             torch.Generator(device=dev).manual_seed(0))
        bad = [n for n, p in state.model.named_parameters()
               if not (bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().sum()) > 0)]
        check(not bad, f"MDMPlus parameters without a finite non-zero gradient: {bad}")
        check(all(t.dtype == torch.float32 for t in (state.params.data, state.optimizer.mu,
                                                     state.optimizer.nu, state.ema)),
              "bf16: master weights, moments or EMA not float32")
        res["all_params_have_gradients"] = len(list(state.model.parameters()))
        cfg = TrainConfig(lr=1e-3)
        state = TrainState(fresh_model(), cfg, 1000)
        step = make_train_step(sched, cfg, builder)
        fixed_losses = [float(step(state, fixed, torch.Generator(device=dev).manual_seed(0))[
            "loss"]) for _ in range(20)]
        check(fixed_losses[-1] < fixed_losses[0], f"fixed batch: loss did not fall {fixed_losses}")
        res["fixed_batch_lr1e-3_losses"] = [fixed_losses[0], fixed_losses[-1]]
        del state, step, cache, fixed

        # 4. serve the trained checkpoint from a training clip's features
        store = read_store(twh.h5file)
        clip = store["0"]
        served_dir = os.path.join(work, "served")
        os.makedirs(served_dir)
        npy = {k: os.path.join(served_dir, k + ".npy") for k in ("textaudio", "seed")}
        np.save(npy["textaudio"],
                np.concatenate([clip["audio"], clip["text"]], 1)[:SERVE_FRAMES])
        np.save(npy["seed"], clip["gesture"][:twh.n_seed + 2])
        ckpt = os.path.join(work, "out_twh+_f32", str(2 * BEAT_TWH_RESUME_AT))
        la.launches = el.launches = el.launches_bf16 = 0
        served, wall = timed(lambda: beat_cli.main(
            ["--config", twh_yml, "--model_path", ckpt, "--textaudio_npy", npy["textaudio"],
             "--seed_gesture_npy", npy["seed"], "--mean_npy", "data/TWH_v0_mean.npy",
             "--std_npy", "data/TWH_v0_std.npy", "--speaker", "8", "--seed", "123456",
             "--save_dir", served_dir] + mode_flags("dpmpp", 5)))
        counts = (la.launches, el.launches, el.launches_bf16)
        motion = served["motion"][0]
        expected = (20, 20 * twh.get("num_layers", 8), 0)  # 4 windows × 5 steps; 8 layers
        check(counts == expected, f"served checkpoint: launches {counts}, expected {expected}")
        check(motion.shape == (SERVE_FRAMES, 744) and bool(np.isfinite(motion).all()),
              f"served checkpoint: motion {motion.shape}, finite {np.isfinite(motion).all()}")
        res["served"] = dict(checkpoint=os.path.relpath(ckpt, work),
                             local_attention_launches=counts[0],
                             encoder_layer_launches=counts[1], frames=SERVE_FRAMES,
                             generate_s=served["generate_seconds"],
                             capture_s=served["capture_seconds"], cli_wall_s=wall)

        # 5. export: the served motion as BVH, and features → BVH → features
        t0 = time.perf_counter()
        bvh = os.path.join(srcs["TWH"], TWH_TRAIN_CLIPS[0] + ".bvh")
        _, pipe = P.twh_features(bvh)
        out_bvh = os.path.join(served_dir, "served.bvh")
        P.twh_features_to_bvh(motion, pipe, out_bvh)
        back = P.parse_bvh(out_bvh)
        check(back.values.shape == (SERVE_FRAMES, 372) and bool(np.isfinite(back.values).all()),
              f"exported BVH: {back.values.shape}, finite {np.isfinite(back.values).all()}")
        export = dict(frames=len(back.values), channels=back.values.shape[1],
                      export_s=time.perf_counter() - t0)
        for dataset, name in (("TWH", TWH_TRAIN_CLIPS[0]), ("BEAT", BEAT_TRAIN_CLIPS[0])):
            featurize, to_bvh = ((P.twh_features, P.twh_features_to_bvh) if dataset == "TWH"
                                 else (P.beat_features, P.beat_features_to_bvh))
            t0 = time.perf_counter()
            parsed = P.parse_bvh(os.path.join(srcs[dataset], name + ".bvh"))
            parse_s = time.perf_counter() - t0
            feats, pipe = featurize(parsed)
            path = os.path.join(served_dir, f"{dataset}_roundtrip.bvh")
            to_bvh(feats, pipe, path, smoothing=False)
            again, _ = featurize(path)
            err = float(np.abs(again - feats[:len(again)]).max())
            check(err <= 1e-4, f"{dataset} features → BVH → features: {err}")
            export[f"{dataset.lower()}_roundtrip_max_abs_err"] = err
            export[f"{dataset.lower()}_bvh_parse_s"] = parse_s
            export[f"{dataset.lower()}_bvh_frames"] = len(parsed.values)
        res["export"] = export
    finally:
        os.chdir(cwd)
    res["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"beat_twh_train [{card}]: {json.dumps(res)}")
    return res


# ---- phase 10 -------------------------------------------------------------------

SERVE_CLIPS = ((1, "Happy"), (2, "Sad"), (1, "Neutral"), (2, "Old"))  # (windows, style)
BURST = 64
BURST_BUCKETS = (1, 2, 5)
STREAM_CHUNK_S = 0.5


def busy_share(run):
    """(device-busy share of the wall time, wall seconds) of run() under
    torch.profiler: the union of the card's kernel and copy intervals over the
    wall time. (None, wall) when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, wall
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e6 / wall, wall


def counted(fn):
    """(fn()'s result, wall seconds, the (A, B f32, B bf16) launches it counted)."""
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la

    la.launches = el.launches = el.launches_bf16 = el.launches_planes = 0
    res, wall = timed(fn)
    return res, wall, (la.launches, el.launches, el.launches_bf16)


def run_stream(stream, data, chunk, flush=False):
    """Push `data` in `chunk`-sized pieces (then flush, if asked): (the motion
    concatenated along time, ms from each window's last input to its motion,
    i.e. the wall time of each push that completed a window)."""
    import numpy as np

    chunks, lat = [], []
    for i in range(0, len(data), chunk):
        got, wall = timed(lambda: stream.push(data[i: i + chunk]))
        chunks += got
        if got:
            lat.append(wall * 1e3)
    if flush:
        got, wall = timed(stream.flush)
        chunks += got
        lat.append(wall * 1e3)
    return np.concatenate(chunks, 1), lat


def phase_serving(dev, tmp, card):
    """Phase 10: the serving surfaces on phase 5's full-width ZEGGS model and
    WavLM-Large and phase 8's TWH model."""
    import contextlib
    import io

    import numpy as np
    import torch
    from scipy.io import wavfile

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import sample as sample_cli
    from diffusestylegesture_torch.cli import sample_beat as beat_cli
    from diffusestylegesture_torch.cli import serve as serve_cli
    from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
    from diffusestylegesture_torch.data import load_wav_16k
    from diffusestylegesture_torch.models.convert import (load_reference_mdm,
                                                          load_reference_mdm_plus,
                                                          load_wavlm_checkpoint)
    from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
    from diffusestylegesture_torch.motion import zeggs_features as zf
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.sample import (BeatTwhStreamSampler, GestureServer,
                                                  ServerConfig, ZeggsEngineConfig, ZeggsSampler,
                                                  ZeggsStreamSampler, edit_motion,
                                                  in_between_mask, prepare_seed_gesture,
                                                  restyle_window, slice_audio_windows)

    cfg_path, mdm_pt = os.path.join(tmp, "zeggs.yml"), os.path.join(tmp, "model000000000.pt")
    cfg = load_yaml_config(cfg_path)
    audio = load_wav_16k(os.path.join(tmp, "015_Happy_4_x_1_0.wav"))
    mean = np.load(os.path.join(cfg.data_dir, "mean.npz"))["mean"]
    std = np.load(os.path.join(cfg.data_dir, "std.npz"))["std"]
    sps = ZeggsEngineConfig().samples_per_stride
    long_audio = np.tile(audio, 3)  # 37.5 s to cut clips of up to 5 windows from
    rng = np.random.default_rng(SEED + 10)
    res, launches = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) cli/serve.py: seeded 1- and 2-window clips, DDPM-1000 as the JAX CLI, max_batch 16
    serve_dir = os.path.join(tmp, "serve")
    os.makedirs(serve_dir)
    with open(os.path.join(serve_dir, "requests.jsonl"), "w") as f:
        for i, (w, style) in enumerate(SERVE_CLIPS):
            path = os.path.join(serve_dir, f"{i:03d}_{style}_0.wav")
            start = int(rng.integers(0, len(long_audio) - 3 * sps))
            clip = long_audio[start: start + w * sps + int(rng.integers(0, sps // 2))]
            wavfile.write(path, 16000, (clip * 32767).astype(np.int16))
            f.write(json.dumps({"wav": path}) + "\n")
    for mode, extra in (("serve", []), ("serve_fast", ["--serve_fast"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out, wall, counts = counted(lambda: serve_cli.main(
                ["--config", cfg_path, "--model_path", mdm_pt, "--requests",
                 os.path.join(serve_dir, "requests.jsonl"), "--max_delay_ms", "200",
                 "--seed", str(SEED)] + extra))
        lines = [json.loads(line) for line in buf.getvalue().splitlines()
                 if line.startswith("{")]
        ok = [line for line in lines if "out" in line]
        check(len(ok) == len(SERVE_CLIPS) and not [line for line in lines if "error" in line],
              f"{mode}: results {lines}")
        check([line["frames"] for line in ok] == [w * 80 - 8 for w, _ in SERVE_CLIPS],
              f"{mode}: frames {[line['frames'] for line in ok]}")
        check(all(os.path.getsize(line["out"]) > 0 for line in ok), f"{mode}: empty BVH")
        check(out["served"] == len(SERVE_CLIPS), f"{mode}: served {out['served']}")
        calls, steps, layers = counts[0], cfg.diffusion_steps, cfg.num_layers
        bf16 = mode == "serve_fast"
        check(calls >= 3 * steps and calls % steps == 0 and
              counts[1:] == ((0, layers * calls) if bf16 else (layers * calls, 0)),
              f"{mode}: launches {counts} (DDPM-{steps}: A a multiple of {steps}, B "
              f"{layers} x A)")
        launches[mode] = counts
        frames = sum(line["frames"] for line in ok)
        res[mode] = dict(wall_s=wall, served=out["served"], batches=out["batches"],
                         capture_s=out["capture_seconds"], denoiser_calls_b16=calls,
                         frames=frames, frames_per_s=frames / wall, launches=counts)
        print(f"serving {mode} (CLI, DDPM-{steps}, max_batch {SERVER_BATCH}) [{card}]: "
              f"{json.dumps(res[mode])}")

    # (b) a library GestureServer burst in dpmpp5, and the same clips one at a time
    wcfg, wavlm = load_wavlm_checkpoint(cfg.wavlm_path, device=dev)
    model = load_reference_mdm(mdm_pt, sample_cli.mdm_config(cfg, wcfg.encoder_embed_dim),
                               device=dev)
    dpmpp5 = D.spaced_schedule(D.named_beta_schedule("cosine", 1000),
                               D.space_timesteps(1000, "ddim5"), device=dev)

    def sampler():  # the serve CLI's engine (crossfade width 1) in dpmpp5
        return ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                            make_zeggs_wavlm_fn(88), dpmpp5,
                            ZeggsEngineConfig(sampler="dpmpp", crossfade_n=1), device=dev)

    def clip(w):
        start = int(rng.integers(0, len(long_audio) - 6 * sps))
        return long_audio[start: start + w * sps + int(rng.integers(0, sps))]

    windows = rng.integers(1, 6, BURST)
    clips = [clip(int(w)) for w in windows]
    styles = np.eye(6, dtype=np.float32)[rng.integers(0, 6, BURST)]
    server = GestureServer(sampler(), model, wavlm, mean, std,
                           ServerConfig(max_batch=SERVER_BATCH, max_delay_ms=20.0,
                                        window_buckets=BURST_BUCKETS), seed=SEED).start()

    def burst(items):
        t0 = time.perf_counter()
        done = {}
        futs = []
        for i, (a, s) in enumerate(items):
            fut = server.submit(a, s)
            fut.add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append((time.perf_counter(), fut))
        outs = [f.result(timeout=600) for _, f in futs]
        wall = time.perf_counter() - t0
        lat = [done[i] - t for i, (t, _) in enumerate(futs)]
        return outs, wall, lat

    try:
        # first use: one request per bucket captures WavLM per bucket and the B = 16 graphs
        _, warm_s, _ = burst([(clip(b), styles[0]) for b in BURST_BUCKETS])
        capture_s = server.sampler.capture_seconds
        batches0 = server.batches_served
        (outs, wall, lat), _, counts = counted(lambda: burst(list(zip(clips, styles))))
        planes = el.launches_planes  # the burst's float32 GEMM grids on weight planes
        batches = server.batches_served - batches0
        check(all(o.shape == (int(w) * 80 - 8, 1141) and np.isfinite(o).all()
                  for o, w in zip(outs, windows)), "server burst: bad output")
        launches["server"] = counts
        check(counts[0] > 0 and counts[1] == cfg.num_layers * counts[0] and counts[2] == 0,
              f"server burst: launches {counts}")
        # B = 16: all four GEMM grids of every kernel-B launch on weight planes
        check(planes == 4 * counts[1], f"server burst: {planes} GEMM grids on weight planes, "
                                       f"expected {4 * counts[1]}")
        share, prof_wall = busy_share(lambda: burst(list(zip(clips, styles))))
    finally:
        server.stop()
    frames = int(sum(o.shape[0] for o in outs))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    res["server"] = dict(
        requests=BURST, windows_per_request=[int(w) for w in windows], buckets=BURST_BUCKETS,
        max_batch=SERVER_BATCH, batches=batches, wall_s=wall, requests_per_s=BURST / wall,
        frames=frames, frames_per_s=frames / wall, p50_latency_s=float(np.percentile(lat, 50)),
        p99_latency_s=float(np.percentile(lat, 99)), first_use_s=warm_s, capture_s=capture_s,
        peak_memory_gb=peak_gb, device_busy_share=share,
        device_idle_share=None if share is None else 1.0 - share,
        profiled_burst_wall_s=prof_wall, launches=counts, encoder_layer_planes_grids=planes)
    print(f"serving server burst (dpmpp5) [{card}]: {json.dumps(res['server'])}")

    solo = sampler()
    gen = lambda k: torch.Generator(device=dev).manual_seed(k)  # noqa: E731
    for w in sorted(set(int(x) for x in windows)):  # capture each window count first
        solo.generate(model, wavlm, clip(w), styles[0], gen(0), mean=mean, std=std)
    solo_out, solo_wall = timed(lambda: [solo.generate(model, wavlm, a, s, gen(i), mean=mean,
                                                       std=std)
                                         for i, (a, s) in enumerate(zip(clips, styles))])
    check(all(o.shape[1] == w * 80 - 8 for o, w in zip(solo_out, windows)), "solo: bad output")
    res["solo"] = dict(requests=BURST, wall_s=solo_wall, requests_per_s=BURST / solo_wall,
                       frames_per_s=frames / solo_wall, capture_s=solo.capture_seconds)
    print(f"serving one at a time (ZeggsSampler.generate, dpmpp5) [{card}]: "
          f"{json.dumps(res['solo'])}")

    # (c) streams over 0.5 s pushes: ZEGGS on the 12.5 s wav, TWH + on phase 8's features
    chunk = int(STREAM_CHUNK_S * 16000)
    style = zf.style_onehot("Happy")[None]

    def zeggs_stream():
        stream = ZeggsStreamSampler(solo, model, wavlm, style, gen(7), mean=mean, std=std)
        return run_stream(stream, audio, chunk)

    zeggs_stream()  # first use captures WavLM for one window
    (got, lat), _, counts = counted(zeggs_stream)
    ref = solo.generate(model, wavlm, audio, style, gen(7), mean=mean, std=std)
    check(got.shape == ref.shape, f"ZEGGS stream shape {got.shape} vs {ref.shape}")
    dev_err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).mean()), 1.0)
    check(dev_err <= E2E_REL * scale, f"ZEGGS stream vs batch engine: {dev_err} > {E2E_REL} rel")
    zeggs_counts = counts

    files = {k: os.path.join(tmp, "beat_twh", f"TWH_{k}") for k in ("yml", "mean.npy", "std.npy",
                                                                    "seed.npy")}
    tcfg = apply_beat_twh_derivations(load_yaml_config(files["yml"],
                                                       {"name": "DiffuseStyleGesture+"}))
    twh = load_reference_mdm_plus(os.path.join(tmp, "beat_twh", "TWH_DiffuseStyleGesture+.pt"),
                                  beat_cli.mdm_plus_config(tcfg), device=dev)
    ta = np.load(os.path.join(tmp, "beat_twh", "TWH_textaudio.npy"))
    tmean, tstd = np.load(files["mean.npy"]), np.load(files["std.npy"])
    tseed = prepare_seed_gesture(np.load(files["seed.npy"])[:32], tmean, tstd)
    tstyle = np.eye(tcfg.style_dim, dtype=np.float32)[[1]]
    tsampler = beat_twh_sampler(dev, tcfg, "attention4", "dpmpp", 5)
    rows = int(STREAM_CHUNK_S * 30)

    def twh_stream():
        stream = BeatTwhStreamSampler(tsampler, twh, tseed, tstyle, gen(8), tmean, tstd)
        return run_stream(stream, ta, rows, flush=True)

    twh_stream()
    (tgot, tlat), _, counts = counted(twh_stream)
    tref = tsampler.generate(twh, ta, tseed, tstyle, gen(8), tmean, tstd)
    check(tgot.shape == tref.shape, f"TWH stream shape {tgot.shape} vs {tref.shape}")
    tdev_err = float(np.abs(tgot - tref).max())
    tscale = max(float(np.abs(tref).mean()), 1.0)
    check(tdev_err <= E2E_REL * tscale, f"TWH stream vs batch engine: {tdev_err} > {E2E_REL} rel")
    launches["stream"] = tuple(a + b for a, b in zip(zeggs_counts, counts))
    res["stream"] = dict(
        zeggs=dict(push_s=STREAM_CHUNK_S, windows=len(lat), window_to_motion_ms=lat,
                   max_abs_dev_from_batch=dev_err, scale=scale, launches=zeggs_counts),
        twh_dsg_plus=dict(push_s=STREAM_CHUNK_S, windows=len(tlat), window_to_motion_ms=tlat,
                          max_abs_dev_from_batch=tdev_err, scale=tscale, launches=counts))
    print(f"serving streams (dpmpp5, {STREAM_CHUNK_S} s pushes) [{card}]: "
          f"{json.dumps(res['stream'])}")

    # (d) restyle (strength 0.5) and an in-between edit on one full-width window,
    # on the model's 1000-step schedule, eagerly
    steps = cfg.diffusion_steps
    sched = D.Schedule.create(D.named_beta_schedule("cosine", steps), device=dev)
    with torch.inference_mode():
        win = torch.as_tensor(slice_audio_windows(audio, ZeggsEngineConfig())[:1], device=dev)
        cond = {"style": torch.as_tensor(style, device=dev),
                "seed": torch.zeros(1, 1141, 1, 8, device=dev),
                "audio": make_zeggs_wavlm_fn(88)(wavlm, win),
                "mask_local": torch.ones(1, 88, dtype=torch.bool, device=dev)}
        target = dict(cond, style=torch.as_tensor(zf.style_onehot("Sad")[None], device=dev))
        norm = (ref[:, :88] - mean) / np.clip(std, 0.01, None)
        motion = torch.as_tensor(norm.transpose(0, 2, 1)[:, :, None, :].copy(), device=dev)
        restyled, restyle_s, counts = counted(lambda: restyle_window(
            sched, lambda x, t, c: model(x, t, c), motion, cond, target, strength=0.5).cpu())
        check(bool(torch.isfinite(restyled).all()) and restyled.shape == motion.shape,
              "restyle: bad output")
        launches["restyle"] = counts
        mask = in_between_mask(tuple(motion.shape), 8, 8, device=dev)
        edited, edit_s, counts = counted(lambda: edit_motion(
            sched, lambda x, t: model(x, t, cond), motion, mask, gen(9)).cpu())
        launches["edit"] = counts
        kept = (edited - motion.cpu())[mask.cpu()].abs().max().item()
        check(bool(torch.isfinite(edited).all()) and kept <= 1e-4,
              f"edit: the kept frames moved by {kept}")
    res["restyle"] = dict(strength=0.5, denoiser_calls=steps + 1, wall_s=restyle_s,
                          mean_abs_change=float((restyled - motion.cpu()).abs().mean()),
                          launches=launches["restyle"])
    res["edit"] = dict(kept_frames="8 + 8 of 88", denoiser_calls=steps, wall_s=edit_s,
                       kept_max_abs_dev=kept, launches=launches["edit"])
    print(f"serving restyle and edit (one window, {steps}-step schedule, eager) [{card}]: "
          f"{json.dumps({k: res[k] for k in ('restyle', 'edit')})}")
    for key in ("serve", "server", "stream", "restyle", "edit"):
        check(launches[key][0] > 0 and launches[key][1] > 0,
              f"{key}: kernels A and B not both launched {launches[key]}")
    check(launches["serve_fast"][2] > 0, "serve --serve_fast: kernel B's bf16 mode not launched")
    res["launches"] = launches
    return res


# ---- phase 11 -------------------------------------------------------------------

ZEROEGGS_STEPS = 30
ZEROEGGS_STEADY_FROM = 5


def phase_zeroeggs(dev, tmp, card):
    """Phase 11: the ZeroEGGS RNN system at the published widths of
    ZeroEGGSConfig through `cli/zeroeggs.py`, on phase 6's seeded clips."""
    import numpy as np
    import torch

    from diffusestylegesture_torch.cli import zeroeggs as zcli
    from diffusestylegesture_torch.motion import bvh
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.sample.engine_zeroeggs import ZeroEggsGenerator

    src = os.path.join(tmp, "zeggs_train", "raw")
    work = os.path.join(tmp, "zeroeggs")
    data, net = os.path.join(work, "data"), os.path.join(work, "net")
    res = {}
    prep = zcli.main(["prepare", "--source", src, "--target", data])
    check(prep["clips"] == len(ZEGGS_CLIPS), f"ZeroEGGS prepare: {prep['clips']} clips")
    res["prepare"] = prep
    la.launches = el.launches = el.launches_bf16 = 0
    train = zcli.main(["train", "--data", data, "--save_dir", net, "--num_steps",
                       str(ZEROEGGS_STEPS)])
    check(all(np.isfinite(train["losses"])), f"ZeroEGGS train: losses {train['losses']}")
    check((la.launches, el.launches, el.launches_bf16) == (0, 0, 0),
          "ZeroEGGS launched a kernel of the diffusion model")
    steady = train["step_seconds"][ZEROEGGS_STEADY_FROM:]
    res["train"] = dict(steps=ZEROEGGS_STEPS, batch=8, window=60, losses=train["losses"],
                        first_step_s=train["step_seconds"][0],
                        ms_per_step=float(np.median(steady)) * 1e3,
                        ms_per_step_min=float(np.min(steady)) * 1e3)
    print(f"zeroeggs train (hidden 512, 2 GRU layers, batch 8 x 60 frames) [{card}]: "
          f"{json.dumps(res['train'])}")

    wav = os.path.join(tmp, "015_Happy_4_x_1_0.wav")  # 12.5 s: 750 frames at 60 fps
    styles = ["--style", os.path.join(src, ZEGGS_CLIPS[0] + ".bvh") + ":0:600",
              "--style", os.path.join(src, ZEGGS_CLIPS[1] + ".bvh") + ":600:1200"]
    for blend in ("add", "stitch"):
        out = zcli.main(["generate", "--network", net, "--stats", os.path.join(data, "stats.npz"),
                         "--audio", wav, "--blend", blend, "--blend_ratio", "0.5", "0.5",
                         "--save_dir", os.path.join(work, "out_" + blend)] + styles)
        anim = bvh.load(out["path"])
        check(out["frames"] == 750 and anim["rotations"].shape == (750, 75, 3)
              and np.isfinite(anim["rotations"]).all(), f"ZeroEGGS generate {blend}: bad BVH")
        res["generate_" + blend] = dict(out, path=os.path.basename(out["path"]),
                                        ms_per_rollout_step=out["generate_seconds"] * 1e3 / 749)
        print(f"zeroeggs generate {blend} (CLI, capture included) [{card}]: "
              f"{json.dumps(res['generate_' + blend])}")

    # the rollout captured and eager in one process, same inputs
    model = zcli.load_network(net, dev)
    stats = dict(np.load(os.path.join(data, "stats.npz")))
    feats = dict(np.load(os.path.join(data, "features.npz")))
    name = ZEGGS_CLIPS[0]
    af, f = feats[f"audio_{name}"][:750], feats[f"feats_{name}"]
    ex = (zcli.anim_input_from_features(f[:600]) - stats["anim_input_mean"]) / \
        stats["anim_input_std"]
    outs, times = {}, {}
    for path, flag in (("graph", None), ("eager", False)):
        gen = ZeroEggsGenerator(model, stats, device=dev, graphs=flag)
        z = gen.encode_style(ex)

        def run():
            return [t.cpu() for t in gen.generate(af, [z], zcli.first_pose_state(f[0]))]

        run()  # capture on the graph path
        outs[path], times[path] = timed(run)
    same = all(torch.equal(a, b) for a, b in zip(outs["graph"], outs["eager"]))
    check(same, "ZeroEGGS: the captured rollout differs from the eager one")
    res["rollout"] = dict(frames=750, graph_s=times["graph"], eager_s=times["eager"],
                          graph_ms_per_step=times["graph"] * 1e3 / 749,
                          eager_ms_per_step=times["eager"] * 1e3 / 749, graph_equals_eager=same)
    print(f"zeroeggs rollout of 750 frames in one process [{card}]: {json.dumps(res['rollout'])}")
    return res


# ---- phase 12 -------------------------------------------------------------------


# the other MDM variants at the ZEGGS widths with MFCC audio: (name, MDMConfig
# fields, kernel A launches, kernel B launches) a denoiser call
MODEL_VARIANTS = (
    ("cla5_style1", dict(cond_mode="cross_local_attention5_style1"), 1, 0),
    ("cla_style1", dict(cond_mode="cross_local_attention_style1"), 1, 8),
    ("style1_trans_enc", dict(cond_mode="style1", arch="trans_enc"), 0, 8),
    ("style2_trans_enc", dict(cond_mode="style2", arch="trans_enc"), 0, 8),
    ("style1_mytrans_enc", dict(cond_mode="style1", arch="mytrans_enc"), 0, 8),
    ("style2_mytrans_enc", dict(cond_mode="style2", arch="mytrans_enc"), 0, 8),
    ("style1_trans_dec", dict(cond_mode="style1", arch="trans_dec"), 0, 0),
    ("style2_gru", dict(cond_mode="style2", arch="gru"), 0, 0),
)
MOE_EXPERTS, MOE_STEPS = 4, 20  # the JAX CLI's capacity factor 2.0; no published expert count
BASELINE_BATCH = 8


def model_pair(dev, **fields):
    """A seeded full-width MDM (MDMConfig defaults: 1141 / 256 / 8 layers / 4
    heads / ff 1024, window 11) on its kernel path, and its plain twin."""
    import torch

    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 12)
        model = MDM(MDMConfig(**fields)).to(dev).eval()
    plain = MDM(MDMConfig(impl="plain", **fields)).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    return model, plain


def mfcc_sampler(dev, sched, sampler, graphs=None, host_s=None):
    """The ZEGGS engine with the host-side MFCC window function; `host_s`, a
    one-element list, accumulates the seconds the function takes."""
    from diffusestylegesture_torch.sample import (ZeggsEngineConfig, ZeggsSampler,
                                                  make_mfcc_window_fn)

    fn = make_mfcc_window_fn(88)
    if host_s is not None:
        inner = fn

        def fn(params, windows):
            out, wall = timed(lambda: inner(params, windows))
            host_s[0] += wall
            return out

        fn.host_side = True
    return ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond), fn, sched,
                        ZeggsEngineConfig(sampler=sampler), device=dev, graphs=graphs)


def rel(out, ref) -> float:
    """max |out − ref| over max(mean |ref|, 1)."""
    import numpy as np

    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).mean()), 1.0)


def denoiser_call(dev, model, plain, batch=1):
    """One denoiser call at `batch` replayed from a CUDA graph (device and wall
    ms) against the plain path on the same inputs: (times, relative error)."""
    import torch

    from diffusestylegesture_torch.utils.graphs import GraphSet

    g = torch.Generator(device=dev).manual_seed(SEED)
    cfg = model.cfg
    A = cfg.audio_feat_dim if cfg.audio_feat != "wavlm" else cfg.audio_in_dim
    x = torch.randn(batch, cfg.njoints, 1, 88, generator=g, device=dev)
    cond = {"style": torch.eye(6, device=dev)[:batch],
            "seed": torch.randn(batch, cfg.njoints, 1, 8, generator=g, device=dev),
            "audio": torch.randn(batch, 88, A, generator=g, device=dev),
            "mask_local": torch.ones(batch, 88, dtype=torch.bool, device=dev)}
    t = torch.full((batch,), 500, device=dev)
    with torch.inference_mode():
        out = torch.empty(batch, cfg.njoints, 1, 88, device=dev)
        replay, _ = GraphSet(dev).capture(lambda: out.copy_(model(x, t, cond)))
        replay.launches = (0,) * len(replay.launches)  # timing calls are not main-path launches
        ms = {"graph_replay_device_ms": device_ms(replay.replay, iters=40, warmup=2)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            replay.replay()
        torch.cuda.synchronize()
        ms["graph_replay_wall_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        replay.replay()
        ref = plain(x, t, cond)
        err = rel(out.cpu().numpy(), ref.cpu().numpy())
    return ms, err, (x, t, cond)


def phase_models(dev, tmp, card, ctx):
    """Phase 12: (a) the MFCC-conditioned ZEGGS model served and streamed, (b)
    the other MDM variants, (c) the MoE trunk from training to serving, (d) the
    baseline generators. Returns the `models` result, with the kernels'
    launches on each path of (a)-(c) under `launches`."""
    import numpy as np
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.data import load_wav_16k
    from diffusestylegesture_torch.motion import zeggs_features as zf
    from diffusestylegesture_torch.sample import ZeggsStreamSampler

    t0 = time.perf_counter()
    betas = D.named_beta_schedule("cosine", 1000)
    scheds = {"ddpm1000": (D.Schedule.create(betas, device=dev), "ddpm", 1000),
              "dpmpp5": (D.spaced_schedule(betas, D.space_timesteps(1000, "ddim5"), device=dev),
                         "dpmpp", 5)}
    wav_path = os.path.join(tmp, "015_Happy_4_x_1_0.wav")
    audio = load_wav_16k(wav_path)
    stats = dict(mean=np.load(os.path.join(tmp, "data", "mean.npz"))["mean"],
                 std=np.load(os.path.join(tmp, "data", "std.npz"))["std"])
    style = zf.style_onehot("Happy")[None]
    frames = 3 * 80 - 8
    gen = lambda s=123456: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    res, launches = {}, {}

    # (a) the MFCC-conditioned model on the CUDA-graph engine, DDPM-1000 and dpmpp5
    model, plain = model_pair(dev, audio_feat="mfcc")
    mfcc = {}
    for mode, (sched, sampler, calls) in scheds.items():
        host = [0.0]
        s = mfcc_sampler(dev, sched, sampler, host_s=host)
        first, first_s = timed(lambda: s.generate(model, None, audio, style, gen(), **stats))
        out, gen_s, counts = counted(lambda: s.generate(model, None, audio, style, gen(),
                                                        **stats))
        expected = (3 * calls, 3 * calls * 8, 0)
        check(counts == expected, f"mfcc {mode}: launches {counts}, expected {expected}")
        check(out.shape == (1, frames, 1141) and bool(np.isfinite(out).all()),
              f"mfcc {mode}: poses {out.shape}")
        eager, eager_s = timed(lambda: mfcc_sampler(dev, sched, sampler, graphs=False).generate(
            model, None, audio, style, gen(), **stats))
        same = bool(np.array_equal(out, eager)) and bool(np.array_equal(first, out))
        check(same, f"mfcc {mode}: graph and eager poses differ")
        launches[f"mfcc_{mode}"] = counts
        mfcc[mode] = dict(first_generate_s=first_s, generate_s=gen_s, eager_generate_s=eager_s,
                          host_mfcc_s_per_call=host[0] / 2,
                          capture_s=s.capture_seconds, frames_per_s=frames / gen_s,
                          local_attention_launches=counts[0], encoder_layer_launches=counts[1],
                          graph_equals_eager=same)
        print(f"models mfcc {mode} [{card}]: {json.dumps(mfcc[mode])}")
    noise = np.random.default_rng(SEED + 2).standard_normal(
        (3, 1, 1141, 1, 88)).astype(np.float32)
    sched = scheds["dpmpp5"][0]
    k_out, p_out = (mfcc_sampler(dev, sched, "dpmpp").generate(m, None, audio, style, gen(),
                                                                noise_windows=noise, **stats)
                    for m in (model, plain))
    mfcc["kernel_vs_plain_rel"] = err = rel(k_out, p_out)
    check(err <= E2E_REL, f"mfcc: kernel vs plain path {err} > {E2E_REL} rel")
    s = mfcc_sampler(dev, sched, "dpmpp")
    ref = s.generate(model, None, audio, style, gen(7), **stats)
    (got, lat), _, counts = counted(lambda: run_stream(
        ZeggsStreamSampler(s, model, None, style, gen(7), **stats), audio,
        int(STREAM_CHUNK_S * 16000)))
    check(got.shape == ref.shape, f"mfcc stream shape {got.shape} vs {ref.shape}")
    mfcc["stream"] = dict(push_s=STREAM_CHUNK_S, window_to_motion_ms=lat,
                          rel_dev_from_batch=rel(got, ref), launches=counts)
    check(mfcc["stream"]["rel_dev_from_batch"] <= E2E_REL, "mfcc stream vs batch engine")
    launches["mfcc_stream"] = counts
    res["mfcc"] = mfcc
    print(f"models mfcc kernel vs plain {err:.3e}, stream [{card}]: {json.dumps(mfcc['stream'])}")
    del model, plain

    # (b) the other variants: one replayed call against the plain path, a dpmpp5 generate
    variants = {}
    for name, fields, a, b in MODEL_VARIANTS:
        model, plain = model_pair(dev, audio_feat="mfcc", **fields)
        ms, err, _ = denoiser_call(dev, model, plain)
        check(err <= E2E_REL, f"{name}: kernel vs plain call {err} > {E2E_REL} rel")
        s = mfcc_sampler(dev, sched, "dpmpp")
        s.generate(model, None, audio, style, gen(), **stats)  # captures
        out, wall, counts = counted(lambda: s.generate(model, None, audio, style, gen(), **stats))
        expected = (15 * a, 15 * b, 0)
        check(counts == expected, f"{name}: launches {counts}, expected {expected}")
        check(out.shape == (1, frames, 1141) and bool(np.isfinite(out).all()),
              f"{name}: poses {out.shape}")
        launches[f"{name}_dpmpp5"] = counts
        variants[name] = dict(call_b1=ms, kernel_vs_plain_rel=err, generate_s=wall,
                              capture_s=s.capture_seconds, local_attention_launches=counts[0],
                              encoder_layer_launches=counts[1])
        print(f"models {name} [{card}]: {json.dumps(variants[name])}")
        del model, plain, s
    res["variants"] = variants

    # (c) MoE: train, serve, one call kernel vs plain
    res["moe"] = phase_moe(dev, card, ctx, wav_path, launches)
    # (d) the baseline generators
    res["baselines"] = phase_baselines(dev, card)
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t0
    return res


def phase_moe(dev, card, ctx, wav_path, launches):
    """`cli.train --moe_experts` on phase 6's prepared clips (device cache,
    captured steps), `cli.sample` on its checkpoint, and one denoiser call of
    it through the kernel and the plain path with the routing compared."""
    import numpy as np
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import sample as sample_cli, train as train_cli
    from diffusestylegesture_torch.data.device_cache import (DeviceWindowCache,
                                                             make_device_data_train_step)
    from diffusestylegesture_torch.models.convert import load_reference_mdm
    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.models.moe import capacity, route
    from diffusestylegesture_torch.train import TrainConfig, TrainState, make_zeggs_cond_builder

    work, config = ctx["work"], ctx["config"]
    res = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        out, _, counts = counted(lambda: train_cli.main(
            ["--config", config, "--num_steps", str(MOE_STEPS), "--save_dir",
             os.path.join(work, "out_moe"), "--log_interval", "10", "--seed", "0",
             "--device_cache", "--moe_experts", str(MOE_EXPERTS)]))
        loop, state = out["loop"], out["state"]
        check(counts == (0, 0, 0), f"moe train: kernels launched while training {counts}")
        check(state.step == MOE_STEPS and state.model.cfg.moe_experts == MOE_EXPERTS,
              f"moe train: step {state.step}, experts {state.model.cfg.moe_experts}")
        logged = [(d["loss"], d["moe_aux"]) for d in loop.logged]
        check(len(logged) >= 2 and bool(np.isfinite(logged).all()), f"moe train: {logged}")
        launches["moe_train"] = counts
        res["train"] = dict(steps=MOE_STEPS, batch=TRAIN_BATCH, experts=MOE_EXPERTS,
                            logged_loss_moe_aux=logged, ms_per_step=steady_ms([loop]),
                            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                            capture_s=loop.captured.capture_seconds)

        cache = DeviceWindowCache.from_zeggs(out["dataset"], dev)
        sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=dev)
        cfg = TrainConfig(lr=3e-5, moe_aux_weight=0.01)
        step = make_device_data_train_step(sched, cfg, make_zeggs_cond_builder(8), TRAIN_BATCH)

        def make():
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                model = MDM(MDMConfig(audio_in_dim=cache.arrays["wavlm"].shape[-1],
                                      moe_experts=MOE_EXPERTS, impl="plain")).to(dev)
            st = TrainState(model, cfg, 1000)
            g = torch.Generator(device=dev).manual_seed(0)
            return (st, lambda: step(st, g, cache.arrays),
                    lambda: step.device_step(st, g, cache.arrays), g)

        equal, eager_ms, captured_ms, run = captured_vs_eager(make, steps=3)
        check(equal, "moe train: the captured step differs from the eager step")
        res["train"].update(captured_equals_eager_3_steps=equal, eager_ms_per_step=eager_ms,
                            captured_ms_per_step=captured_ms)
        del run, cache
        print(f"models moe train [{card}]: {json.dumps(res['train'])}")

        ckpt = os.path.join(work, "out_moe", str(MOE_STEPS))
        served, _, counts = counted(lambda: sample_cli.main(
            ["--config", config, "--model_path", ckpt, "--audiowavlm_path", wav_path,
             "--sampler", "dpmpp", "--respace", "5", "--save_dir",
             os.path.join(work, "served_moe"), "--seed", "123456"]))
        poses = served["poses"]
        check(poses.shape == (1, 3 * 80 - 8, 1141) and bool(np.isfinite(poses).all()),
              f"moe served: poses {poses.shape}")
        check(counts == (15, 0, 0), f"moe served: launches {counts}, expected (15, 0, 0)")
        launches["moe_served"] = counts
        res["served"] = dict(generate_s=served["generate_seconds"],
                             capture_s=served["capture_seconds"], local_attention_launches=15,
                             encoder_layer_launches=0)

        mcfg = MDMConfig(moe_experts=MOE_EXPERTS)
        model = load_reference_mdm(os.path.join(ckpt, "model.pt"), mcfg, device=dev)
        plain = load_reference_mdm(os.path.join(ckpt, "model.pt"),
                                   dataclasses.replace(mcfg, impl="plain"), device=dev)
        routes = {"kernel": [], "plain": []}

        def record(experts, mod, args):
            xf = args[0].reshape(-1, args[0].shape[-1])
            experts.append(route(xf, mod.router, mod.num_experts,
                                 capacity(len(xf), mod.num_experts, mod.capacity_factor))[2])
        ms, err, inputs = denoiser_call(dev, model, plain)
        with torch.inference_mode():  # each path once more, eagerly, its routing recorded
            for name, m in (("kernel", model), ("plain", plain)):
                for layer in m.seqTransEncoder.layers:
                    layer.moe.register_forward_pre_hook(functools.partial(record, routes[name]))
                m(*inputs)
        flips = int(sum(int((a != b).sum()) for a, b in zip(routes["kernel"], routes["plain"])))
        check(err <= E2E_REL, f"moe call: kernel vs plain {err} > {E2E_REL} rel")
        res["call_b1"] = dict(ms, kernel_vs_plain_rel=err, routing_flips=flips,
                              tokens_routed=8 * 89)
        print(f"models moe served and one call [{card}]: "
              f"{json.dumps(dict(res['served'], call_b1=res['call_b1']))}")
    finally:
        os.chdir(cwd)
    return res


def phase_baselines(dev, card):
    """The reference's baseline generators at B = 8: timed, finite, shaped;
    no diffusion kernel launched."""
    import torch

    from diffusestylegesture_torch.models import baselines as bl
    from diffusestylegesture_torch.models import diffwav as dw
    from diffusestylegesture_torch.models import local_transformer as lt
    from diffusestylegesture_torch.models import unet1d as un
    from diffusestylegesture_torch.models.tisa import Tisa

    B = BASELINE_BATCH
    torch.manual_seed(SEED + 40)
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    wav = 0.1 * torch.randn(B, 64000, generator=g, device=dev)
    pose = torch.rand(B, 240, 135, generator=g, device=dev) * 2 - 1
    res = {}

    def run(name, fn, shape):
        out, wall = timed(lambda: (fn(), torch.cuda.synchronize())[0])
        out = out if torch.is_tensor(out) else out[0]
        check(tuple(out.shape) == shape and bool(torch.isfinite(out.float()).all()),
              f"{name}: output {tuple(out.shape)}, expected {shape}")
        res[name] = dict(s=wall, shape=list(shape))

    def loss_backward(model, loss_fn):
        model.train()
        loss = loss_fn()
        loss.backward()
        check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  for p in model.parameters() if p.requires_grad), "a gradient is not finite")
        model.eval()
        return loss.detach()[None]

    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la

    la.launches = el.launches = el.launches_bf16 = 0
    with torch.no_grad():
        enc = bl.WavEncoder().to(dev).eval()
        run("wav_encoder", lambda: enc(wav), (B, 240, 32))
        for name, cls in (("generator_linear", bl.GeneratorLinear),
                          ("generator_gru", bl.GeneratorGRU)):
            m = cls().to(dev).eval()
            run(name, lambda: m(wav)[0], (B, 240, 512))
            run(name + "_sample", lambda: m.sample(wav), (B, 240))
        s2s = bl.Seq2SeqNet(vocab=20000, embed_size=300, hidden_size=200, pose_dim=135,
                            n_frames=240).to(dev).eval()
        tokens = torch.randint(0, 20000, (B, 40), generator=g, device=dev)
        run("seq2seq", lambda: s2s(tokens, pose), (B, 240, 135))
        tisa = Tisa().to(dev)
        run("tisa_t240", lambda: tisa(240), (12, 240, 240))
    gd = un.GeneratorDiff().to(dev)
    gsched = un.make_generator_diff_schedule(250, device=dev)
    run("generator_diff_loss_backward", lambda: loss_backward(
        gd, lambda: un.generator_diff_loss(gd, gsched, pose, wav, g)), (1,))
    run("generator_diff_sample_250", lambda: un.generator_diff_sample(gd, gsched, wav, g),
        (B, 240, 135))
    dwm = dw.DiffWavModel().to(dev)
    run("diffwav_loss_backward", lambda: loss_backward(
        dwm, lambda: dw.diffwav_training_loss(dwm, pose, wav, g)), (1,))
    run("diffwav_sample_50", lambda: dw.diffwav_sample(dwm, wav, g), (B, 240, 135))
    # the upstream local-attention README's LocalTransformer
    ltm = lt.LocalTransformer(num_tokens=256, max_seq_len=8192, dim=512, depth=6,
                              local_attn_window_size=256).to(dev).eval()
    prime = torch.randint(0, 256, (B, 1), generator=g, device=dev)
    run("local_transformer_generate_512", lambda: lt.generate(ltm, prime, 512, generator=g),
        (B, 512))
    counts = (la.launches, el.launches, el.launches_bf16)
    check(counts == (0, 0, 0), f"baselines: diffusion kernels launched {counts}")
    print(f"models baselines (B={B}) [{card}]: {json.dumps(res)}")
    return res


# ---- phase 13 -------------------------------------------------------------------

# kernel B at the text-to-motion trunk's shapes: T (6 s, 8.8 s, 9.8 s = 196
# frames + the token; 32-key tiles at head dim 128) at D 512, and batches (one prompt under CFG, `generate`'s 3
# repetitions under CFG, the reference evaluation's 32 prompts under CFG)
T2M_SHAPES = (121, 177, 197)
T2M_BATCHES = (2, 6, 64)
T2M_WIDE = (400, 256)  # a long T at head dim 64 (64-key tiles)
T2M_CLIPS = 160
T2M_BATCH = 64           # cli.train_t2m's default
T2M_TRAIN_STEPS = 20
T2M_DIFFUSION_STEPS = 1000
T2M_RESPACE = 50
# cli.generate's runs: DDPM at 9.8 s (T 197) and at its default 6 s (T 121),
# DDIM 50 at 9.8 s
T2M_RUNS = ("ddpm_9.8s", "ddpm_6.0s", "ddim50_9.8s")
T2M_PROMPT = "a person walks forward slowly"
T2M_TOKENS = "a/DET person/NOUN walk/VERB forward/ADV slowly/ADV"
T2M_CAPTIONS = (("a person walks forward slowly", T2M_TOKENS),
                ("someone waves the left hand", "someone/PRON wave/VERB the/DET left/ADJ "
                                                 "hand/NOUN"),
                ("a man jumps up and down", "a/DET man/NOUN jump/VERB up/ADV and/CCONJ "
                                            "down/ADV"),
                ("a person turns around", "a/DET person/NOUN turn/VERB around/ADV"))
T2M_WORDS = ("unk", "sos", "eos", "a", "person", "walk", "forward", "slowly", "someone", "wave",
             "the", "left", "hand", "man", "jump", "up", "and", "down", "turn", "around")
# the published CLIP ViT-B/32 text tower: width 512, 12 layers, 8 heads, 77 tokens
T2M_CLIP_FLAGS = ("--clip_width", "512", "--clip_layers", "12")


def write_t2m_corpus(root, n, seed=SEED):
    """A seeded HumanML3D-format corpus: 263-d `new_joint_vecs` of 40-196
    frames (20 fps, smooth), `caption#tokens#0.0#0.0` text files (two captions
    a clip), a split file, Mean / Std and a 300-d GloVe table of its words."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("new_joint_vecs", "texts", "glove")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    ids = []
    for i in range(n):
        name = f"{i:06d}"
        ids.append(name)
        length = int(rng.integers(40, 197))
        t = np.arange(length)[:, None] / 20.0
        freq = rng.uniform(0.2, 1.5, (1, 263))
        motion = np.sin(2 * np.pi * freq * t + rng.uniform(0, 6, (1, 263))) \
            + 0.05 * rng.standard_normal((length, 263))
        np.save(os.path.join(dirs["new_joint_vecs"], name + ".npy"), motion.astype(np.float32))
        caps = [T2M_CAPTIONS[i % len(T2M_CAPTIONS)], T2M_CAPTIONS[(i + 1) % len(T2M_CAPTIONS)]]
        with open(os.path.join(dirs["texts"], name + ".txt"), "w") as f:
            f.write("".join(f"{c}#{tok}#0.0#0.0\n" for c, tok in caps))
    split = os.path.join(root, "train.txt")
    with open(split, "w") as f:
        f.write("\n".join(ids))
    frames = np.concatenate([np.load(os.path.join(dirs["new_joint_vecs"], n_ + ".npy"))
                             for n_ in ids])
    np.save(os.path.join(root, "Mean.npy"), frames.mean(0))
    np.save(os.path.join(root, "Std.npy"), frames.std(0) + 1e-6)
    np.save(os.path.join(dirs["glove"], "our_vab_data.npy"),
            rng.standard_normal((len(T2M_WORDS), 300)).astype(np.float32))
    with open(os.path.join(dirs["glove"], "our_vab_words.pkl"), "wb") as f:
        pickle.dump(list(T2M_WORDS), f)
    with open(os.path.join(dirs["glove"], "our_vab_idx.pkl"), "wb") as f:
        pickle.dump({w: i for i, w in enumerate(T2M_WORDS)}, f)
    return dict(motion_dir=dirs["new_joint_vecs"], text_dir=dirs["texts"], split=split,
                mean=os.path.join(root, "Mean.npy"), std=os.path.join(root, "Std.npy"),
                glove=dirs["glove"])


def phase_t2m_kernel(dev):
    """Phase 13 (a): kernel B at the text-to-motion trunk's shapes, 8 seeded
    layers, both operand modes, against the plain layer; times beside the
    plain layer, nn.TransformerEncoderLayer and the bound; which attention
    grid each shape takes."""
    import torch
    from torch import nn

    from diffusestylegesture_torch.models.transformer import TorchTransformerEncoder
    from diffusestylegesture_torch.ops import encoder_layer as el

    H, F, L = 4, 1024, 8
    rows = []
    cases = [(T, 512, B) for T in T2M_SHAPES for B in T2M_BATCHES] + [(*T2M_WIDE, 2)]
    for T, D, B in cases:
        torch.manual_seed(SEED)
        trunk = TorchTransformerEncoder(L, D, H, F, "gelu").to(dev).eval()
        layer = trunk.layers[0]
        ref = nn.TransformerEncoderLayer(D, H, F, dropout=0.0, activation="gelu",
                                         batch_first=True, norm_first=False).to(dev).eval()
        ref.load_state_dict(layer.state_dict())
        tile = el.key_tile(D, H)
        check(tile >= 0, f"kernel B takes no attention grid at D={D}, H={H}")
        nbytes, flops = encoder_layer_cost(B, T, D, H, F)
        with torch.no_grad():
            x = torch.randn(B, T, D, device=dev)
            for mode, (bf16, atol, products, rate) in ENCODER_MODES.items():
                h, worst = x, 0.0
                for i, lyr in enumerate(trunk.layers):
                    out = el.encoder_layer(h, lyr, mxu_bf16=bf16)
                    err = (out - lyr(h, mxu_bf16=bf16)).abs().max().item()
                    check(err <= atol, f"t2m encoder_layer {mode} ({B}, {T}, {D}) layer {i} "
                                       f"err {err}")
                    worst = max(worst, err)
                    h = out
                again = el.encoder_layer(x, layer, mxu_bf16=bf16)
                check(torch.equal(again, el.encoder_layer(x, layer, mxu_bf16=bf16)),
                      f"t2m encoder_layer {mode} ({B}, {T}, {D}): two calls differ")

                def library():
                    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                        return ref(x)

                row = dict(B=B, T=T, D=D, H=H, F=F, mode=mode, key_tile=tile,
                           plan=el.describe_plan(B, T, D, H, F, bf16), max_abs_err=worst,
                           ms=device_ms(lambda: el.encoder_layer(x, layer, mxu_bf16=bf16)),
                           plain_ms=device_ms(lambda: layer(x, mxu_bf16=bf16), iters=10),
                           library_ms=device_ms(library, iters=10))
                row["bound_ms"], row["bound_by"] = bound(nbytes, products * flops, rate)
                rows.append(row)
                print(f"t2m encoder_layer: {json.dumps(row)}")
    return rows


def t2m_denoiser_call(dev, model, plain, text_emb, frames):
    """One TextMDM call at the CFG batch of `text_emb` replayed from a CUDA
    graph (device and wall ms) against the plain path: (times, rel error)."""
    import torch

    from diffusestylegesture_torch.utils.graphs import GraphSet

    g = torch.Generator(device=dev).manual_seed(SEED)
    B = 2 * text_emb.shape[0]
    x = torch.randn(B, model.cfg.njoints, 1, frames, generator=g, device=dev)
    cond = {"text_emb": torch.cat([text_emb, text_emb])}
    uncond = torch.arange(B, device=dev) >= B // 2
    t = torch.full((B,), 500, device=dev)
    with torch.inference_mode():
        out = torch.empty_like(x)
        replay, _ = GraphSet(dev).capture(lambda: out.copy_(model(x, t, cond, uncond=uncond)))
        replay.launches = (0,) * len(replay.launches)  # timing calls are not main-path launches
        ms = {"graph_replay_device_ms": device_ms(replay.replay, iters=20, warmup=2)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            replay.replay()
        torch.cuda.synchronize()
        ms["graph_replay_wall_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        replay.replay()
        err = rel(out.cpu().numpy(), plain(x, t, cond, uncond=uncond).cpu().numpy())
    return ms, err


def synthetic_smpl_arrays(rng, V=6890, J=24, nb=10):
    """Seeded SMPL-shaped arrays (the neutral model's sizes): a body-sized
    template, small blend shapes, row-normalised regressors and weights."""
    import numpy as np

    from diffusestylegesture_torch.models.smpl import SMPL_PARENTS

    reg = rng.random((J, V)) ** 8
    w = rng.random((V, J)) ** 6
    extra = rng.random((9, V)) ** 8
    return dict(v_template=0.5 * rng.standard_normal((V, 3)),
                shapedirs=0.01 * rng.standard_normal((V, 3, nb)),
                posedirs=0.001 * rng.standard_normal(((J - 1) * 9, V * 3)),
                J_regressor=reg / reg.sum(1, keepdims=True),
                weights=w / w.sum(1, keepdims=True),
                J_regressor_extra=extra / extra.sum(1, keepdims=True),
                kintree_parents=np.asarray(SMPL_PARENTS))


def phase_t2m(dev, tmp, card):
    """Phase 13 (b)-(d): text-to-motion training, serving and evaluation at
    the HumanML3D widths with seeded weights."""
    import numpy as np
    import torch

    from diffusestylegesture_torch.cli import generate, train_t2m
    from diffusestylegesture_torch.data import humanml as hd
    from diffusestylegesture_torch.eval import action2motion as a2m
    from diffusestylegesture_torch.eval import stgcn
    from diffusestylegesture_torch.eval import t2m_evaluator as tev
    from diffusestylegesture_torch.models import smpl
    from diffusestylegesture_torch.models.clip_text import caption_encoder_from_spec
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "t2m")
    corpus = write_t2m_corpus(root, T2M_CLIPS)
    data_flags = ["--motion_dir", corpus["motion_dir"], "--text_dir", corpus["text_dir"],
                  "--split", corpus["split"], "--mean", corpus["mean"], "--std", corpus["std"],
                  "--batch_size", str(T2M_BATCH), "--num_frames", "196",
                  "--diffusion_steps", str(T2M_DIFFUSION_STEPS), *T2M_CLIP_FLAGS]
    res = {"corpus_clips": T2M_CLIPS}

    # (b) training: float32 and --bf16 at the published widths, plain trunk
    for name, extra in (("f32", []), ("bf16", ["--bf16"])):
        save = os.path.join(root, f"save_{name}")
        torch.cuda.reset_peak_memory_stats(dev)
        la.launches = el.launches = el.launches_bf16 = 0
        run, wall = timed(lambda: train_t2m.main(
            data_flags + ["--save_dir", save, "--num_steps", str(T2M_TRAIN_STEPS),
                          "--log_interval", "5", "--save_interval", str(T2M_TRAIN_STEPS)]
            + extra))
        launches = (la.launches, el.launches, el.launches_bf16)
        losses = [d["loss"] for d in run["loop"].logged]
        check(launches == (0, 0, 0), f"t2m training launched kernels: {launches}")
        check(len(losses) > 0 and bool(np.isfinite(losses).all()),
              f"t2m training {name}: losses {losses}")
        res[f"train_{name}"] = dict(
            steps=run["state"].step, batch=T2M_BATCH, losses=losses,
            ms_per_step=steady_ms([run["loop"]]),
            peak_bytes=torch.cuda.max_memory_allocated(dev), caption_encode_s=run["encode_s"],
            cli_wall_s=wall, launches=launches)
        print(f"t2m train {name} [{card}]: {json.dumps(res[f'train_{name}'])}")
    save = os.path.join(root, "save_f32")

    # (c) serving: cli.generate on the float32 checkpoint, CUDA graphs
    prompt = ["--text_prompt", T2M_PROMPT, "--num_repetitions", "3", "--guidance_param", "2.5",
              "--save_feats"]
    runs = dict(zip(T2M_RUNS, ((["--motion_length", "9.8"], T2M_DIFFUSION_STEPS),
                               ([], T2M_DIFFUSION_STEPS),
                               (["--motion_length", "9.8", "--sampler", "ddim", "--respace",
                                 str(T2M_RESPACE)], T2M_RESPACE))))
    layers = 8
    served, outs = {}, {}
    for name, (flags, steps) in runs.items():
        out_dir = os.path.join(root, f"gen_{name}")
        out, wall, counts = counted(lambda: generate.main(
            ["--model_path", save, "--output_dir", out_dir] + prompt + flags))
        check(counts == (0, steps * layers, 0),
              f"t2m generate {name}: launches {counts}, expected (0, {steps * layers}, 0)")
        results = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
        frames = 196 if "9.8" in name else 120
        check(results["motion"].shape == (3, 22, 3, frames)
              and bool(np.isfinite(results["motion"]).all()),
              f"t2m generate {name}: motion {results['motion'].shape}")
        outs[name] = out
        served[name] = dict(local_attention_launches=counts[0], encoder_layer_launches=counts[1],
                            encoder_layer_bf16_launches=counts[2], frames=frames, motion_shape=list(results["motion"].shape),
                            generate_s=generate.LAST_RUN["seconds"],
                            capture_s=generate.LAST_RUN["capture_seconds"], cli_wall_s=wall,
                            key_tile=el.key_tile(512, 4))
        print(f"t2m generate {name} [{card}]: {json.dumps(served[name])}")
    # the same 9.8 s DDPM run through the eager loop (`TextMotionSampler(...,
    # graphs=False)`, the CLI's seed): its features bitwise equal to the CLI's on graphs
    from diffusestylegesture_torch.sample import TextMotionSampler

    with open(os.path.join(save, "t2m_config.json")) as f:
        spec = json.load(f)
    encode, _ = caption_encoder_from_spec(spec["clip"], save, dev)
    cfg, model = generate.load_t2m_model(save, dev)
    _, plain = generate.load_t2m_model(save, dev, impl="plain")
    emb = torch.from_numpy(np.tile(encode([T2M_PROMPT]), (3, 1))).to(dev)
    eager, wall, counts = counted(lambda: TextMotionSampler(
        model, encode, generate.make_schedule(cfg, 0, dev), graphs=False).sample(emb, 196, 10))
    feats = eager[:, :, 0, :].transpose(1, 2).cpu().numpy() * np.load(cfg["std"]) \
        + np.load(cfg["mean"])
    check(np.array_equal(feats, np.load(os.path.join(outs["ddpm_9.8s"], "results_feats.npy"))),
          "t2m generate: graphs and the eager loop differ")
    served["eager_ddpm_9.8s"] = dict(encoder_layer_launches=counts[1], generate_s=wall,
                                     bitwise_equal_to_graphs=True)
    # the kernel path against the plain path on the same noise (DDIM 50, 9.8 s)
    sched = generate.make_schedule(cfg, T2M_RESPACE, dev)
    kernel_out = TextMotionSampler(model, encode, sched, "ddim").sample(emb, 196, SEED)
    plain_out = TextMotionSampler(plain, encode, sched, "ddim", graphs=False).sample(
        emb, 196, SEED)
    kp_err = rel(kernel_out.cpu().numpy(), plain_out.cpu().numpy())
    check(kp_err <= E2E_REL, f"t2m kernel path vs plain path: rel {kp_err}")
    served["kernel_vs_plain_ddim50_rel"] = kp_err
    served["denoiser_b6"], call_err = t2m_denoiser_call(dev, model, plain, emb, 196)
    check(call_err <= E2E_REL, f"t2m denoiser call kernel vs plain: rel {call_err}")
    served["denoiser_b6"]["rel_err_vs_plain"] = call_err
    res["serve"] = served

    # (d) evaluation at the published widths, seeded weights
    ev = {}
    wv = hd.WordVectorizer(corpus["glove"], "our_vab")
    mean, std = np.load(corpus["mean"]), np.load(corpus["std"])
    dcfg = hd.T2MConfig(motion_dir=corpus["motion_dir"], text_dir=corpus["text_dir"],
                        max_motion_length=196)
    gt = list(hd.Text2MotionDataset(dcfg, mean, std, corpus["split"], wv, seed=0).batches(32))
    feats = np.concatenate([np.load(os.path.join(outs[n], "results_feats.npy"))
                            for n in ("ddpm_9.8s", "ddim50_9.8s")])
    n = len(feats)
    tokens = ["sos/OTHER"] + T2M_TOKENS.split(" ") + ["eos/OTHER"]
    w_embs = np.zeros((n, dcfg.max_text_len + 2, 300), np.float32)
    pos = np.zeros((n, dcfg.max_text_len + 2, len(hd.POS_enumerator)), np.float32)
    for j, tk in enumerate(tokens):
        w_embs[:, j], pos[:, j] = wv[tk]
    gen = {"word_embs": w_embs, "pos_ohot": pos, "cap_lens": np.full(n, len(tokens)),
           "motions": ((feats - mean) / std).astype(np.float32), "m_lens": np.full(n, 196)}
    evaluator = tev.T2MEvaluator(tev.T2MEvaluator.seeded_checkpoint(SEED), device=dev)
    t0 = time.perf_counter()
    match, rprec, acts = tev.evaluate_matching_score(evaluator, {"gen": [gen], "gt": gt})
    fids = tev.evaluate_fid(evaluator, gt, acts)
    divs = {**tev.evaluate_diversity({"gen": acts["gen"]}, n - 1),
            **tev.evaluate_diversity({"gt": acts["gt"]}, min(100, len(acts["gt"]) - 1))}
    torch.cuda.synchronize()
    ev["t2m"] = dict(matching_score={k: float(v) for k, v in match.items()},
                     r_precision_top123={k: v.tolist() for k, v in rprec.items()},
                     fid={k: float(v) for k, v in fids.items()}, diversity=divs,
                     gt_rows=len(acts["gt"]), gen_rows=n, seconds=time.perf_counter() - t0)
    values = [*match.values(), *fids.values(), *divs.values()] + \
        [x for v in rprec.values() for x in v]
    check(bool(np.isfinite(values).all()), f"t2m evaluation: {ev['t2m']}")
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        a2 = stgcn.A2MEvaluation(None, 6, 40, init_seed=SEED, device=dev)
        motion = torch.randn(64, a2.graph.num_node, 6, 60, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        f, logits = a2.model(motion)
        # the evaluators launch many small kernels: wall time with the card synchronized
        ev["stgcn"] = dict(input=list(motion.shape),
                           wall_ms=timed_steps(lambda: a2.model(motion), 10))
        check(f.shape == (64, 256) and logits.shape == (64, 40)
              and bool(torch.isfinite(logits).all()), "stgcn: features or logits")
        disc = a2m.MotionDiscriminator(72).to(dev).eval()
        m = torch.randn(64, 24, 3, 60, device=dev)
        lengths = torch.full((64,), 60, device=dev)
        yh = disc(m, lengths)
        ev["motion_discriminator"] = dict(input=[64, 72, 60],
                                          wall_ms=timed_steps(lambda: disc(m, lengths), 10))
        check(yh.shape == (64, 12) and bool(torch.isfinite(yh).all()), "motion discriminator")
        r2x = smpl.Rotation2xyz(smpl.SmplJoints(smpl.SmplModel.from_arrays(
            dev, **synthetic_smpl_arrays(rng))))
        x6 = 0.5 * torch.randn(64, 25, 6, 60, device=dev)

        def to_xyz():
            return r2x(x6, None, pose_rep="rot6d", translation=True, glob=True,
                       jointstype="smpl", vertstrans=False)

        xyz = to_xyz()
        ev["rotation2xyz"] = dict(input=list(x6.shape), output=list(xyz.shape),
                                  wall_ms=timed_steps(to_xyz, 5))
        check(xyz.shape == (64, 24, 3, 60) and bool(torch.isfinite(xyz).all()), "rotation2xyz")
    res["eval"] = ev
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"t2m [{card}]: {json.dumps(res)}")
    return res


# ---- phase 14 -------------------------------------------------------------------


def phase_export(tmp, card):
    """Phase 14: phase 9's TWH and BEAT training BVHs and its written BVH through
    `cli.export_gltf` to GLB and the player HTML; `read_glb` reads each GLB back."""
    from diffusestylegesture_torch.cli import export_gltf
    from diffusestylegesture_torch.motion import gltf_export
    from diffusestylegesture_torch.motion import pipeline as P

    work = os.path.join(tmp, "beat_twh_train")
    bvhs = [os.path.join(work, "twh_raw", TWH_TRAIN_CLIPS[0] + ".bvh"),
            os.path.join(work, "beat_raw", BEAT_TRAIN_CLIPS[0] + ".bvh"),
            os.path.join(work, "served", "served.bvh")]
    out_dir = os.path.join(tmp, "export")
    written, wall = timed(lambda: export_gltf.main(bvhs + ["--outdir", out_dir, "--player"]))
    check(len(written) == 2 * len(bvhs), f"export: wrote {written}")
    res = {"cli_wall_s": wall, "files": {}}
    for path in bvhs:
        stem = os.path.splitext(os.path.basename(path))[0]
        track = P.parse_bvh(path)
        glb = os.path.join(out_dir, stem + ".glb")
        gltf, blob = gltf_export.read_glb(glb)
        rotated = sum(len(P.joint_rot_order(track, j)) == 3 for j in track.names)
        moved = sum(len([c for c in track.channels.get(j, []) if c.endswith("position")]) == 3
                    for j in track.names)
        channels = len(gltf["animations"][0]["channels"])
        check(len(gltf["nodes"]) == len(track.names) and len(gltf["animations"]) == 1
              and channels == rotated + moved,
              f"export {stem}: {len(gltf['nodes'])} nodes for {len(track.names)} joints, "
              f"{channels} channels for {rotated + moved}")
        res["files"][stem] = dict(frames=len(track.values), joints=len(track.names),
                                  nodes=len(gltf["nodes"]), channels=channels,
                                  glb_bytes=os.path.getsize(glb),
                                  html_bytes=os.path.getsize(os.path.join(out_dir, stem + ".html")))
    print(f"export [{card}]: {json.dumps(res)}")
    return res


# ---- phase 15 ------------------------------------------------------------------


PARALLEL_STEPS = 20  # cli.train steps of each phase-15 run
PARALLEL_LOG = 5
PARALLEL_MICROBATCHES = 4
MESH_BATCH = 16  # the server's batch, spread over the serving mesh
# (name, cli.train flags past the shared ones); {d} is the degree min(2, cards)
PARALLEL_TRAIN_RUNS = (
    ("use_mesh", ["--use_mesh"]),
    ("fsdp", ["--use_mesh", "--fsdp"]),
    ("tp", ["--tp", "{d}"]),
    ("sp", ["--sp", "{d}"]),
    ("pp", ["--pp", "{d}", "--pipe_microbatches", "{m}"]),
)


def parallel_train_args(work, name, flags, degree):
    """cli.train's flags; the pipelined runs take 4 microbatches on one card and
    `degree` on more (batch 300 over data 2 leaves 150 rows a rank)."""
    micro = PARALLEL_MICROBATCHES if degree == 1 else degree
    return (["--config", os.path.join(HERE, "configs", "zeggs.yml"),
             "--num_steps", str(PARALLEL_STEPS), "--log_interval", str(PARALLEL_LOG),
             "--seed", "0", "--device_cache", "--save_dir", os.path.join(work, f"out_par_{name}")]
            + [f.format(d=degree, m=micro) for f in flags])


def parallel_train_run(dev, work, name, flags, degree):
    """One cli.train run in this process: its logged losses, ms/step, peak
    memory and kernel launches."""
    import torch

    from diffusestylegesture_torch.cli import train as train_cli

    torch.cuda.reset_peak_memory_stats(dev)
    out, wall, counts = counted(lambda: train_cli.main(
        parallel_train_args(work, name, flags, degree)))
    loop = out["loop"]
    losses = [float(d["loss"]) for d in loop.logged]
    return dict(losses=losses, ms_per_step=steady_ms([loop]), wall_s=wall,
                peak_memory_bytes=torch.cuda.max_memory_allocated(dev), launches=counts,
                captured=loop.captured is not None,
                capture_s=loop.captured.capture_seconds if loop.captured is not None else 0.0,
                moment_elements=loop.state.optimizer.mu.numel(),
                param_elements=loop.state.params.numel)


def parallel_inference(dev, mdm_pt, mesh_size):
    """(c): one ZEGGS denoiser call at B = 16 through sequence-parallel local
    attention (kernel A over [halo | shard]) and through the pipelined trunk
    (kernel B per stage, 4 microbatches), each against the plain path; their
    launches and device times beside the unsharded kernel path's."""
    import torch

    from diffusestylegesture_torch.models.convert import load_reference_mdm
    from diffusestylegesture_torch.models.mdm import MDMConfig
    from diffusestylegesture_torch.parallel import multihost

    seq = multihost.global_mesh(("seq",), (mesh_size,))
    pipe = multihost.global_mesh(("pipe",), (mesh_size,))
    g = torch.Generator(device=dev).manual_seed(SEED)
    B = MESH_BATCH
    x = torch.randn(B, 1141, 1, 88, generator=g, device=dev)
    t = torch.randint(0, 1000, (B,), generator=g, device=dev)
    cond = {"style": torch.eye(6, device=dev)[torch.arange(B, device=dev) % 6],
            "seed": torch.randn(B, 1141, 1, 8, generator=g, device=dev),
            "audio": torch.randn(B, 88, 1024, generator=g, device=dev),
            "mask_local": torch.ones(B, 88, dtype=torch.bool, device=dev)}
    plain = load_reference_mdm(mdm_pt, MDMConfig(impl="plain"), device=dev)
    kernel = load_reference_mdm(mdm_pt, MDMConfig(), device=dev)
    res = {}
    with torch.inference_mode():
        ref = plain(x, t, cond)
        for name, cfg in (("seq_parallel", MDMConfig(seq_parallel=True, seq_mesh=seq)),
                          ("pipeline", MDMConfig(trunk_impl="pipeline", pipe_mesh=pipe,
                                                 pipe_microbatches=PARALLEL_MICROBATCHES))):
            model = load_reference_mdm(mdm_pt, cfg, device=dev)
            out, _, counts = counted(lambda: model(x, t, cond))
            err = rel(out.float().cpu().numpy(), ref.float().cpu().numpy())
            check(err <= E2E_REL, f"{name} inference: {err} > {E2E_REL} rel of the plain path")
            res[name] = dict(kernel_vs_plain_rel=err, local_attention_launches=counts[0],
                             encoder_layer_launches=counts[1],
                             encoder_layer_bf16_launches=counts[2],
                             # two calls: the pipelined one launches ~300 kernels (kernel B
                             # seven grids a layer), and more would fill the launch queue
                             ms=device_ms(lambda: model(x, t, cond), iters=2, warmup=2))
        res["unsharded_kernel_ms"] = device_ms(lambda: kernel(x, t, cond), iters=4, warmup=2)
    per = 8 // mesh_size
    check(res["seq_parallel"]["local_attention_launches"] == 1
          and res["seq_parallel"]["encoder_layer_launches"] == 8,
          f"seq_parallel inference launches {res['seq_parallel']}")
    check(res["pipeline"]["local_attention_launches"] == 1
          and res["pipeline"]["encoder_layer_launches"] == per * PARALLEL_MICROBATCHES,
          f"pipelined inference launches {res['pipeline']}")
    return res


def _parallel_rank(rank, world, port, work, mdm_pt, out_dir):
    """One rank of phase 15's spawned group (NCCL, one card a rank): the meshed
    cli.train runs, then the sequence-parallel and pipelined inference."""
    import torch

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    sys.path.insert(0, HERE)
    from diffusestylegesture_torch import resolve_device
    from diffusestylegesture_torch.parallel import multihost

    torch.cuda.set_device(rank)
    dev = resolve_device(f"cuda:{rank}")
    res = {"train": {}}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        degree = min(2, world)
        for name, flags in PARALLEL_TRAIN_RUNS:
            res["train"][name] = parallel_train_run(dev, work, name, flags, degree)
        res["inference"] = parallel_inference(dev, mdm_pt, world)
    finally:
        os.chdir(cwd)
        multihost.shutdown()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_parallel(dev, tmp, card, ctx):
    """15. (a) ZEGGS (dpmpp5, DDPM-1000) and TWH + (dpmpp5) served at B = 16
    over a mesh of every visible card, against the one-card run; (b) cli.train
    at full width on phase 6's clips in a spawned NCCL group of one rank a
    card, under --use_mesh, --fsdp, --tp, --sp and --pp; (c) sequence-parallel
    and pipelined inference in that group."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import sample_beat as beat_cli
    from diffusestylegesture_torch.config import apply_beat_twh_derivations, load_yaml_config
    from diffusestylegesture_torch.data import load_wav_16k
    from diffusestylegesture_torch.models.convert import (load_reference_mdm,
                                                          load_reference_mdm_plus,
                                                          load_wavlm_checkpoint)
    from diffusestylegesture_torch.models.mdm import MDMConfig
    from diffusestylegesture_torch.parallel import make_mesh, multihost
    from diffusestylegesture_torch.sample import prepare_seed_gesture

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    mesh = make_mesh()
    res = {"cards": cards, "card": card, "mesh_batch": MESH_BATCH, "serving": {}}

    # (a) serving over the mesh
    mdm_pt = os.path.join(tmp, "model000000000.pt")
    model = load_reference_mdm(mdm_pt, MDMConfig(), device=dev)
    _, wavlm = load_wavlm_checkpoint(os.path.join(tmp, "WavLM-Large.pt"), device=dev)
    audio = load_wav_16k(os.path.join(tmp, "015_Happy_4_x_1_0.wav"))
    style = np.eye(6, dtype=np.float32)[np.arange(MESH_BATCH) % 6]
    betas = D.named_beta_schedule("cosine", 1000)

    def serve(name, make, call, frames):
        out = {}
        for label, m in (("one_card", None), ("mesh", mesh)):
            sampler = make()
            call(sampler, m)  # captures the graphs
            (poses, wall, counts) = counted(lambda: call(sampler, m))
            out[label] = (poses, wall, counts, sampler.lane_launches if m is not None else None)
        (p1, w1, c1, _), (pm, wm, cm, lanes) = out["one_card"], out["mesh"]
        err = rel(pm, p1)
        check(pm.shape == p1.shape and err <= E2E_REL,
              f"{name}: mesh vs one card {err} > {E2E_REL} rel")
        # a lane's (A, B f32, B bf16) launches (its fourth: GEMM grids on weight planes)
        check(all(tuple(lane[:3]) == c1 for lane in lanes)
              and len(lanes) == min(cards, MESH_BATCH),
              f"{name}: per-card launches {lanes}, the one-card run's {c1}")
        res["serving"][name] = dict(
            mesh_vs_one_card_rel=err, one_card_s=w1, mesh_s=wm,
            one_card_frames_per_s=MESH_BATCH * frames / w1, mesh_frames_per_s=MESH_BATCH * frames / wm,
            launches_one_card=c1, launches_per_card=[list(lane) for lane in lanes],
            launches_mesh_total=cm)
        print(f"parallel serving {name} [{card}]: {json.dumps(res['serving'][name])}")

    for name, sampler_kind, steps in (("zeggs_dpmpp5", "dpmpp", 5), ("zeggs_ddpm1000", "ddpm", 1000)):
        sched = (D.Schedule.create(betas, device=dev) if steps == 1000 else
                 D.spaced_schedule(betas, D.space_timesteps(1000, f"ddim{steps}"), device=dev))
        serve(name, lambda: zeggs_sampler(dev, sched, sampler_kind),
              lambda s, m: s.generate(model, wavlm, audio, style,
                                      torch.Generator(device=dev).manual_seed(123456),
                                      mesh=m),
              3 * 80 - 8)
    files = {k: os.path.join(tmp, "beat_twh", f"TWH_{k}") for k in ("yml", "mean.npy", "std.npy",
                                                                    "seed.npy")}
    tcfg = apply_beat_twh_derivations(load_yaml_config(files["yml"],
                                                       {"name": "DiffuseStyleGesture+"}))
    twh = load_reference_mdm_plus(os.path.join(tmp, "beat_twh", "TWH_DiffuseStyleGesture+.pt"),
                                  beat_cli.mdm_plus_config(tcfg), device=dev)
    ta = np.load(os.path.join(tmp, "beat_twh", "TWH_textaudio.npy"))
    tmean, tstd = np.load(files["mean.npy"]), np.load(files["std.npy"])
    tseed = prepare_seed_gesture(np.load(files["seed.npy"])[:32], tmean, tstd)
    tstyle = np.eye(tcfg.style_dim, dtype=np.float32)[np.arange(MESH_BATCH) % tcfg.style_dim]
    serve("twh_dsg+_dpmpp5", lambda: beat_twh_sampler(dev, tcfg, "attention4", "dpmpp", 5),
          lambda s, m: s.generate(twh, ta, tseed, tstyle,
                                  torch.Generator(device=dev).manual_seed(123456), tmean, tstd,
                                  mesh=m),
          ta.shape[0])
    del model, wavlm, twh
    torch.cuda.empty_cache()
    res["serving_s"] = time.perf_counter() - t_phase

    # (b) and (c): one rank a card
    work = ctx["work"]
    degree = min(2, cards)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # the world-1 runs the meshed ones are held to: the plain trunk's, and
        # the pipelined trunk's (its dropout masks are drawn per layer, its own)
        ref = {"plain": parallel_train_run(dev, work, "world1", [], degree),
               "pp": parallel_train_run(dev, work, "world1_pp",
                                        ["--pp", "1", "--pipe_microbatches", "{m}"], 1)}
        multihost.shutdown()
    finally:
        os.chdir(cwd)
    out_dir = os.path.join(tmp, "parallel_ranks")
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(_parallel_rank, args=(cards, multihost.free_port(), work, mdm_pt, out_dir),
             nprocs=cards, join=True)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(cards)]
    res["train_spawn_s"] = time.perf_counter() - t0
    res["train"] = {"degree": degree}
    for key, r in (("world1", ref["plain"]), ("world1_pp", ref["pp"])):
        res["train"][key] = {k: v for k, v in r.items() if k != "losses"}
        res["train"][key + "_losses"] = r["losses"]
    for name, _ in PARALLEL_TRAIN_RUNS:
        runs = [r["train"][name] for r in ranks]
        base = ref["pp"] if name == "pp" else ref["plain"]
        errs = []
        for r in runs:
            errs.append(float(np.max(np.abs(np.array(r["losses"]) - np.array(base["losses"]))
                                     / np.abs(np.array(base["losses"])))))
            check(bool(np.isfinite(r["losses"]).all()) and errs[-1] <= 1e-5,
                  f"parallel train {name}: losses {r['losses']} vs world 1 {base['losses']}")
            check(r["launches"] == (0, 0, 0), f"parallel train {name}: kernels launched "
                                              f"{r['launches']}")
        res["train"][name] = dict(
            losses=runs[0]["losses"], loss_vs_world1_rel=max(errs),
            launches=[list(r["launches"]) for r in runs],
            ms_per_step=[r["ms_per_step"] for r in runs],
            peak_memory_bytes=[r["peak_memory_bytes"] for r in runs],
            captured=runs[0]["captured"], capture_s=runs[0]["capture_s"],
            moment_elements=runs[0]["moment_elements"], param_elements=runs[0]["param_elements"])
    res["inference"] = [r["inference"] for r in ranks]
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"parallel train and inference [{card}]: "
          f"{json.dumps({k: res[k] for k in ('train', 'inference')})}")
    return res


SERVING_PATHS = ("serve", "serve_fast", "server", "stream", "restyle", "edit")


def kernel_entries(la_err, la_t, el_err, el_t, e2e, distill, beat_twh, beat_twh_train, serving,
                   models, t2m_rows, t2m, parallel):
    """The `kernels` line's entries: each kernel with its launches on every
    path, its errors and its times at each shape it was timed at."""
    kernels = []
    el_src = ("diffusestylegesture_torch/csrc/encoder_layer.cu",
              "diffusestylegesture_tpu/ops/encoder_layer_pallas.py:120")
    la_keys = ("ms", "no_mask_ms", "distinct_ms", "distinct_bound_ms", "empty_launch_ms",
               "plain_ms", "library_ms")

    def at_shapes(t, keys, shapes):
        return {shape: {f"b{B}": dict({key: tb[key] for key in keys if key in tb},
                                      bound_ms=tb["bound"][0], bound_by=tb["bound"][1])
                        for B, tb in t[shape].items()}
                for shape in shapes}

    la_extra = dict({key: la_t["zeggs"][1][key] for key in la_keys[1:5]},
                    shapes=at_shapes(la_t, la_keys, ("beat", "twh")))
    el_keys = ("ms", "plain_ms", "library_ms", "max_abs_err")
    beat_twh_runs = [r[0] for r in BEAT_TWH_RUNS]
    # each kernel's launches on its path: DDPM-1000 (f32), and the dpmpp5
    # --serve_fast run for kernel B's bf16 mode
    for name, (src, replaces), err, t, shape, path, extra in (
            ("local_attention", ("diffusestylegesture_torch/csrc/local_attention.cu",
                                 "diffusestylegesture_tpu/ops/local_attention_pallas.py:80"),
             la_err, la_t["zeggs"], "q=k=v (1, 8, 88, 32) strided in, merged out, w=11",
             "ddpm1000", la_extra),
            ("encoder_layer", el_src, el_err["f32"], el_t["f32"]["zeggs"],
             "x (1, 89, 256), H=4, F=1024, float32 (3xTF32)", "ddpm1000",
             dict(shapes=at_shapes(el_t["f32"], el_keys, ("beat", "twh")))),
            ("encoder_layer_bf16", el_src, el_err["bf16"], el_t["bf16"]["zeggs"],
             "x (1, 89, 256), H=4, F=1024, mxu_bf16", "dpmpp5_serve_fast",
             dict(shapes=at_shapes(el_t["bf16"], el_keys, ("beat", "twh"))))):
        batches = {}
        for B in (2, SERVER_BATCH):
            tb = batches[B] = dict(ms=t[B]["ms"], plain_ms=t[B]["plain_ms"],
                                   library_ms=t[B]["library_ms"], bound_ms=t[B]["bound"][0],
                                   bound_by=t[B]["bound"][1])
            tb.update({key: t[B][key] for key in la_keys[1:5] if key in t[B]})
        # the serving surfaces (phase 10): (A, B f32, B bf16) launches per path
        column = {"local_attention": 0, "encoder_layer": 1, "encoder_layer_bf16": 2}[name]
        # the distillation path (phase 7): the teacher's two calls a step at B = 300
        b300 = distill["b300"].get(name)
        if b300 is not None:
            b300 = dict({k: v for k, v in b300.items() if k != "bound"},
                        bound_ms=b300["bound"][0], bound_by=b300["bound"][1])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=e2e[path][f"{name}_launches"], launches_path=path,
            max_abs_err=err, ms=t[1]["ms"], plain_ms=t[1]["plain_ms"],
            bound_ms=t[1]["bound"][0], bound_by=t[1]["bound"][1],
            library_ms=t[1]["library_ms"], shape=shape,
            launches_dpmpp5=e2e["dpmpp5"][f"{name}_launches"],
            launches_distill=distill["cli"].get(f"{name}_launches", 0),
            launches_beat_twh={run: beat_twh[run][f"{name}_launches"] for run in beat_twh_runs},
            # phase 9: none while training; the trained checkpoint served in dpmpp5
            launches_beat_twh_train=dict(
                train=0, served_checkpoint=beat_twh_train["served"].get(f"{name}_launches", 0)),
            launches_serving={path: serving["launches"][path][column] for path in SERVING_PATHS},
            # phase 12: the MFCC model, the other variants, the MoE trunk
            launches_models={path: counts[column] for path, counts in models["launches"].items()},
            # phase 13: text-to-motion generate (float32 trunk; A runs on no t2m path)
            launches_t2m={run: t2m["serve"][run][f"{name}_launches"] for run in T2M_RUNS},
            # phase 15: per card on the serving mesh, per rank on the sequence-
            # parallel and pipelined calls and the meshed training runs (none)
            launches_parallel=dict(
                {run: [lane[column] for lane in r["launches_per_card"]]
                 for run, r in parallel["serving"].items()},
                seq_parallel_call=[r["seq_parallel"][f"{name}_launches"]
                                   for r in parallel["inference"]],
                pipelined_call=[r["pipeline"][f"{name}_launches"]
                                for r in parallel["inference"]],
                train={run: [counts[column] for counts in parallel["train"][run]["launches"]]
                       for run, _ in PARALLEL_TRAIN_RUNS}),
            b2=batches[2], b16=batches[SERVER_BATCH], b300=b300, **extra))
    # kernel B's text-to-motion rows (phase 13a), on both of its entries by mode
    for k in kernels[1:]:
        mode = "f32" if k["name"] == "encoder_layer" else "bf16"
        k["t2m_shapes"] = [{key: v for key, v in row.items() if key != "mode"}
                           for row in t2m_rows if row["mode"] == mode]
    return kernels


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "diffusestylegesture_torch")):
        print("chip_smoke: the diffusestylegesture_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from diffusestylegesture_torch import resolve_device
    from diffusestylegesture_torch.ops import build

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = resolve_device("cuda")  # also switches TF32 off for matmuls and cuDNN
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 still enabled")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    kernel_module = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} (CUDA runtime {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}, NVIDIA kernel module {kernel_module}, "
          f"kernels built by {nvcc}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.2f} s")
    for name, log in build.build_logs.items():
        print(f"-- nvcc {name}\n{log.strip()}")

    # 3-5
    la_err, la_t = phase_local_attention(dev)
    el_err, el_t = phase_encoder_layer(dev)
    with tempfile.TemporaryDirectory(prefix="dsg_chip_smoke_") as tmp:
        e2e = phase_end_to_end(dev, tmp, card)
        # 6
        wav_path = os.path.join(tmp, "015_Happy_4_x_1_0.wav")
        train, ctx = phase_training(dev, tmp, card, os.path.join(tmp, "WavLM-Large.pt"),
                                    wav_path)
        # 7
        distill = phase_distill_eval(dev, card, ctx, wav_path)
        # 8
        beat_twh = phase_beat_twh(dev, tmp, card, os.path.join(tmp, "WavLM-Large.pt"))
        # 9
        beat_twh_train = phase_beat_twh_training(dev, tmp, card,
                                                 os.path.join(tmp, "WavLM-Large.pt"),
                                                 os.path.join(tmp, "beat_twh", "words.vec"))
        # 10-11, each with its wall seconds
        serving, serving_s = timed(lambda: phase_serving(dev, tmp, card))
        zeroeggs, zeroeggs_s = timed(lambda: phase_zeroeggs(dev, tmp, card))
        serving["phase_s"], zeroeggs["phase_s"] = serving_s, zeroeggs_s
        print(f"phase 10 {serving_s:.1f} s, phase 11 {zeroeggs_s:.1f} s")
        # 12
        models = phase_models(dev, tmp, card, ctx)
        print(f"phase 12 {models['phase_s']:.1f} s")
        # 13-14
        (t2m_rows, t2m), t2m_s = timed(lambda: (phase_t2m_kernel(dev), phase_t2m(dev, tmp, card)))
        export = phase_export(tmp, card)
        t2m["phase_wall_s"] = t2m_s
        print(f"phase 13 {t2m_s:.1f} s, phase 14 {export['cli_wall_s']:.1f} s")
        # 15
        parallel = phase_parallel(dev, tmp, card, ctx)
        print(f"phase 15 {parallel['phase_s']:.1f} s")

    # 16. lines
    kernels = kernel_entries(la_err, la_t, el_err, el_t, e2e, distill, beat_twh, beat_twh_train,
                             serving, models, t2m_rows, t2m, parallel)
    check(all(k["launches"] > 0 for k in kernels), "a kernel was not launched on its path")
    check(all(k["launches_distill"] > 0 for k in kernels[:2]),
          "a kernel was not launched on the distillation path")
    check(all(k["launches_beat_twh"]["twh_dsg+_dpmpp5" if k["name"] != "encoder_layer_bf16"
                                     else "twh_dsg+_dpmpp5_serve_fast"] > 0 for k in kernels),
          "a kernel was not launched on the BEAT/TWH serving path")
    check(all(k["launches_beat_twh_train"]["served_checkpoint"] > 0 for k in kernels[:2]),
          "a kernel was not launched serving the BEAT/TWH checkpoint trained in phase 9")
    check(all(k["launches_serving"][path] > 0 for k in kernels[:2]
              for path in ("serve", "server", "stream", "restyle", "edit"))
          and kernels[2]["launches_serving"]["serve_fast"] > 0,
          "a kernel was not launched on a serving surface")
    check(all(k["launches_models"][path] > 0 for k in kernels[:2]
              for path in ("mfcc_ddpm1000", "mfcc_dpmpp5", "mfcc_stream", "cla_style1_dpmpp5"))
          and kernels[0]["launches_models"]["moe_served"] > 0
          and kernels[1]["launches_models"]["style2_mytrans_enc_dpmpp5"] > 0,
          "a kernel was not launched on a phase 12 path")
    check(all(kernels[1]["launches_t2m"][run] > 0 for run in T2M_RUNS),
          "kernel B was not launched on the text-to-motion generate path")
    check(all(min(k["launches_parallel"][run]) > 0 for k in kernels[:2]
              for run in parallel["serving"])
          and min(kernels[0]["launches_parallel"]["seq_parallel_call"]) > 0
          and min(kernels[1]["launches_parallel"]["pipelined_call"]) > 0,
          "a kernel was not launched on a parallel path (mesh serving, sequence-parallel or "
          "pipelined inference)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": e2e, "build_s": build_s}))
    print(json.dumps({"train": train, "card": card}))
    print(json.dumps({"distill": distill, "card": card}))
    print(json.dumps({"beat_twh": beat_twh, "card": card}))
    print(json.dumps({"beat_twh_train": beat_twh_train, "card": card}))
    print(json.dumps({"serving": serving, "card": card}))
    print(json.dumps({"zeroeggs": zeroeggs, "card": card}))
    print(json.dumps({"models": models, "card": card}))
    print(json.dumps({"t2m": t2m, "card": card}))
    print(json.dumps({"export": export, "card": card}))
    print(json.dumps({"parallel": parallel, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
