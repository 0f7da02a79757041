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
     (B·8, 150, 64) window 15), B = 1 and 2, all-true / partial / no mask,
     aliased (q = k = v) and distinct q, k, v, packed contiguous and
     strided-in / merged-out, atol 1e-5; two calls bitwise equal; times of the
     kernel with the boolean mask and with no mask, of an empty kernel launched
     the same way, of the plain version and of SDPA (block-causal boolean mask);
  4. encoder-layer kernel vs the plain layer at the ZEGGS (B, 89, 256), BEAT
     (B, 151, 384) and TWH (B, 151, 512) trunk shapes, B = 1 and 2, with 8
     layers of seeded weights each, in both operand modes: float32 (3xTF32,
     the main path) at atol 1e-4 per layer, `mxu_bf16` against the plain bf16
     layer at atol 1e-2 per layer; two calls on the same input bitwise equal;
     kernel, plain and nn.TransformerEncoderLayer times (under bf16 autocast
     for the bf16 mode), each mode with the bound of its tensor-core work;
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
  10. print the card line, a `kernels` JSON line, an `e2e` JSON line, a `train`
     JSON line, a `distill` JSON line, a `beat_twh` JSON line, a
     `beat_twh_train` JSON line and, last, {"ok": true, "device": {...}}.

Device times of the kernels come from CUDA events around back-to-back calls
queued behind a sleep kernel, so host launch overhead is not in them.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
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
        for B in (1, 2):
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
            for B in (1, 2):
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
                        bound=bound(nbytes, products * flops, rate), max_abs_err=worst)
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
        la.launches = el.launches = el.launches_bf16 = 0
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
        results[mode] = dict(denoiser_calls=calls, local_attention_launches=counts[0],
                             encoder_layer_launches=counts[1],
                             encoder_layer_bf16_launches=counts[2],
                             generate_s=gen_s, capture_s=cap_s, cli_wall_s=wall, frames=frames,
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
        replay.launches = (0, 0, 0)  # timing calls are not main-path launches
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
            bound=bound(nbytes, 3 * flops, TF32_FLOPS_PER_S))
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
        replay.launches = (0, 0, 0)  # timing calls are not main-path launches
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


def kernel_entries(la_err, la_t, el_err, el_t, e2e, distill, beat_twh, beat_twh_train):
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
        b2 = dict(ms=t[2]["ms"], plain_ms=t[2]["plain_ms"], library_ms=t[2]["library_ms"],
                  bound_ms=t[2]["bound"][0], bound_by=t[2]["bound"][1])
        b2.update({key: t[2][key] for key in la_keys[1:5] if key in t[2]})
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
            b2=b2, b300=b300, **extra))
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

    # 10. lines
    kernels = kernel_entries(la_err, la_t, el_err, el_t, e2e, distill, beat_twh, beat_twh_train)
    check(all(k["launches"] > 0 for k in kernels), "a kernel was not launched on its path")
    check(all(k["launches_distill"] > 0 for k in kernels[:2]),
          "a kernel was not launched on the distillation path")
    check(all(k["launches_beat_twh"]["twh_dsg+_dpmpp5" if k["name"] != "encoder_layer_bf16"
                                     else "twh_dsg+_dpmpp5_serve_fast"] > 0 for k in kernels),
          "a kernel was not launched on the BEAT/TWH serving path")
    check(all(k["launches_beat_twh_train"]["served_checkpoint"] > 0 for k in kernels[:2]),
          "a kernel was not launched serving the BEAT/TWH checkpoint trained in phase 9")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": e2e, "build_s": build_s}))
    print(json.dumps({"train": train, "card": card}))
    print(json.dumps({"distill": distill, "card": card}))
    print(json.dumps({"beat_twh": beat_twh, "card": card}))
    print(json.dumps({"beat_twh_train": beat_twh_train, "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
