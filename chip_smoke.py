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
  4. encoder-layer kernel vs the plain layer at (1, 89, 256) and (2, 89, 256)
     with 8 layers of seeded weights, in both operand modes: float32 (3xTF32,
     the main path) at atol 1e-4 per layer, `mxu_bf16` against the plain bf16
     layer at atol 1e-2 per layer; two calls on the same input bitwise equal;
     kernel, plain and nn.TransformerEncoderLayer times (under bf16 autocast
     for the bf16 mode), each mode with the bound of its tensor-core work;
  5. end to end at full width through `cli.sample.main`: a seeded random MDM
     (1141 / 256 / 8 layers / 4 heads / ff 1024) and WavLM-Large (24 layers,
     d 1024) in reference checkpoint layout, a seeded 12.5 s wav (3 windows);
     DDPM-1000 and the gated dpmpp5 mode; launch counters reset before and read
     after each run and held to the expected counts; then dpmpp5 through the
     kernel path and the plain path on the same injected noise, ≤ 2e-3 rel;
  6. print the card line, a `kernels` JSON line, an `e2e` JSON line and, last,
     {"ok": true, "device": {...}}.

Device times of the kernels come from CUDA events around back-to-back calls
queued behind a sleep kernel, so host launch overhead is not in them.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

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


def phase_encoder_layer(dev):
    import torch
    from torch import nn

    from diffusestylegesture_torch.models.transformer import TorchTransformerEncoder
    from diffusestylegesture_torch.ops import encoder_layer as el

    T, D, H, F, L = 89, 256, 4, 1024, 8
    torch.manual_seed(SEED)
    trunk = TorchTransformerEncoder(L, D, H, F, "gelu").to(dev).eval()
    max_err = {mode: 0.0 for mode in ENCODER_MODES}
    timings = {mode: {} for mode in ENCODER_MODES}
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
                h = x
                for i, lyr in enumerate(trunk.layers):
                    out = el.encoder_layer(h, lyr, mxu_bf16=bf16)
                    torch.cuda.synchronize()
                    err = (out - lyr(h, mxu_bf16=bf16)).abs().max().item()
                    check(err <= atol, f"encoder_layer {mode} B={B} layer {i} err {err}")
                    max_err[mode] = max(max_err[mode], err)
                    h = out
                stack_err = (h - trunk(x, impl="plain", mxu_bf16=bf16)).abs().max().item()
                again = el.encoder_layer(x, layer, mxu_bf16=bf16)
                check(torch.equal(again, el.encoder_layer(x, layer, mxu_bf16=bf16)),
                      f"encoder_layer {mode} B={B}: two calls on one input differ")
                print(f"encoder_layer {mode} B={B}: max per-layer err {max_err[mode]:.3e} "
                      f"(atol {atol:g}), 8-layer stack err {stack_err:.3e}, repeat calls "
                      f"bitwise equal")

                def library():
                    if not bf16:
                        return ref(x)
                    with torch.autocast("cuda", dtype=torch.bfloat16):
                        return ref(x)

                if bf16:
                    auto_err = (library().float() - layer(x, mxu_bf16=True)).abs().max().item()
                    print(f"nn.TransformerEncoderLayer under bf16 autocast vs the plain bf16 "
                          f"layer: max abs err {auto_err:.3e}")
                    check(auto_err <= 0.1, f"bf16 autocast layer disagrees: {auto_err}")
                # the plain bf16 layer and the autocast layer launch ~3x the
                # kernels of the f32 ones: 10 calls stay within the launch queue
                iters = 10 if bf16 else 30
                timings[mode][B] = dict(
                    ms=device_ms(lambda: el.encoder_layer(x, layer, mxu_bf16=bf16)),
                    plain_ms=device_ms(lambda: layer(x, mxu_bf16=bf16), iters=iters),
                    library_ms=device_ms(library, iters=iters),
                    bound=bound(nbytes, products * flops, rate))
                print(f"encoder_layer {mode} B={B} timings: {json.dumps(timings[mode][B])}")
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


def phase_end_to_end(dev, tmp):
    import numpy as np
    import torch

    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.cli import sample as sample_cli
    from diffusestylegesture_torch.config import load_yaml_config
    from diffusestylegesture_torch.data import load_wav_16k
    from diffusestylegesture_torch.models.convert import load_reference_mdm, load_wavlm_checkpoint
    from diffusestylegesture_torch.models.mdm import MDMConfig
    from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
    from diffusestylegesture_torch.ops import encoder_layer as el
    from diffusestylegesture_torch.ops import local_attention as la
    from diffusestylegesture_torch.sample import ZeggsEngineConfig, ZeggsSampler, slice_audio_windows

    t0 = time.perf_counter()
    cfg_path, mdm_pt, wav_path = write_full_width_run(tmp, dev)
    setup_s = time.perf_counter() - t0
    print(f"full-width checkpoints written in {setup_s:.1f} s")
    windows, frames = 3, 3 * 80 - 8
    results = {}
    for mode, extra, calls_per_window in (("ddpm1000", [], 1000),
                                          ("dpmpp5", ["--sampler", "dpmpp", "--respace", "5"], 5)):
        la.launches = 0
        el.launches = 0
        el.launches_bf16 = 0
        t0 = time.perf_counter()
        res = sample_cli.main(["--config", cfg_path, "--model_path", mdm_pt,
                               "--audiowavlm_path", wav_path,
                               "--save_dir", os.path.join(tmp, "out_" + mode),
                               "--seed", "123456"] + extra)
        wall = time.perf_counter() - t0
        counts = (la.launches, el.launches)
        bf16_launches = el.launches_bf16
        calls = windows * calls_per_window
        poses = res["poses"]
        check(len(res["paths"]) == 1 and os.path.getsize(res["paths"][0]) > 0,
              f"{mode}: no BVH written")
        check(poses.shape == (1, frames, 1141), f"{mode}: poses shape {poses.shape}")
        check(bool(np.isfinite(poses).all()), f"{mode}: non-finite poses")
        check(counts == (calls, 8 * calls),
              f"{mode}: launches {counts}, expected {(calls, 8 * calls)}")
        results[mode] = dict(denoiser_calls=calls, local_attention_launches=counts[0],
                             encoder_layer_launches=counts[1],
                             encoder_layer_bf16_launches=bf16_launches,
                             generate_s=res["generate_seconds"], cli_wall_s=wall,
                             frames=frames, frames_per_s=frames / res["generate_seconds"])
        print(f"e2e {mode}: {json.dumps(results[mode])}")

    # kernel path vs plain path, dpmpp5, same weights and injected noise
    cfg = load_yaml_config(cfg_path)
    wcfg, wavlm = load_wavlm_checkpoint(cfg.wavlm_path, device=dev)
    sched = D.spaced_schedule(D.named_beta_schedule("cosine", 1000),
                              D.space_timesteps(1000, "ddim5"), device=dev)
    audio = load_wav_16k(wav_path)
    noise = np.random.default_rng(SEED + 1).standard_normal(
        (windows, 1, 1141, 1, 88)).astype(np.float32)
    mean = np.load(os.path.join(cfg.data_dir, "mean.npz"))["mean"]
    std = np.load(os.path.join(cfg.data_dir, "std.npz"))["std"]
    style = np.eye(6, dtype=np.float32)[:1]
    poses = {}
    for impl in ("kernel", "plain"):
        model = load_reference_mdm(mdm_pt, MDMConfig(impl=impl), device=dev)
        sampler = ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                               make_zeggs_wavlm_fn(88), sched,
                               ZeggsEngineConfig(sampler="dpmpp"), device=dev)
        gen = torch.Generator(device=dev).manual_seed(123456)
        poses[impl] = sampler.generate(model, wavlm, audio, style, gen, mean=mean, std=std,
                                       noise_windows=noise)
    scale = float(np.abs(poses["plain"]).mean())
    err = float(np.abs(poses["kernel"] - poses["plain"]).max())
    print(f"kernel path vs plain path (dpmpp5): max abs err {err:.3e}, scale {scale:.3f}")
    check(err <= E2E_REL * max(scale, 1.0), f"kernel vs plain path: {err} > {E2E_REL} rel")

    # WavLM-Large over the clip's windows, and one denoiser call per path
    feats_fn = make_zeggs_wavlm_fn(88)
    win = torch.as_tensor(slice_audio_windows(audio, ZeggsEngineConfig()), device=dev)
    with torch.inference_mode():
        # ~700 launches a call: one call stays within the launch queue
        wavlm_ms = device_ms(lambda: feats_fn(wavlm, win), iters=1, warmup=1)
        x = torch.randn(1, 1141, 1, 88, device=dev)
        cond = {"style": torch.as_tensor(style, device=dev),
                "seed": torch.zeros(1, 1141, 1, 8, device=dev),
                "audio": feats_fn(wavlm, win)[:1],
                "mask_local": torch.ones(1, 88, dtype=torch.bool, device=dev)}
        tt = torch.tensor([500], device=dev)
        step = {}
        for impl in ("kernel", "plain"):
            model = load_reference_mdm(mdm_pt, MDMConfig(impl=impl), device=dev)
            # 83 (kernel) to 203 (plain) launches a call: 4 calls stay
            # within the launch queue
            step[impl + "_device_ms"] = device_ms(lambda: model(x, tt, cond), iters=4, warmup=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                model(x, tt, cond)
            torch.cuda.synchronize()
            step[impl + "_wall_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    results["kernel_vs_plain_max_abs_err"] = err
    results["kernel_vs_plain_scale"] = scale
    results["wavlm_large_3_windows_ms"] = wavlm_ms
    results["denoiser_call_b1"] = step
    print(f"denoiser call B=1: {json.dumps(step)}; WavLM-Large 3 windows {wavlm_ms:.3f} ms")
    return results


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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

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
        e2e = phase_end_to_end(dev, tmp)

    # 6. lines
    kernels = []
    el_src = ("diffusestylegesture_torch/csrc/encoder_layer.cu",
              "diffusestylegesture_tpu/ops/encoder_layer_pallas.py:120")
    la_keys = ("ms", "no_mask_ms", "distinct_ms", "distinct_bound_ms", "empty_launch_ms",
               "plain_ms", "library_ms")
    la_extra = dict(
        {key: la_t["zeggs"][1][key] for key in la_keys[1:5]},
        shapes={shape: {f"b{B}": dict({key: t[key] for key in la_keys},
                                      bound_ms=t["bound"][0], bound_by=t["bound"][1])
                        for B, t in la_t[shape].items()}
                for shape in ("beat", "twh")})
    for name, (src, replaces), err, t, shape, extra in (
            ("local_attention", ("diffusestylegesture_torch/csrc/local_attention.cu",
                                 "diffusestylegesture_tpu/ops/local_attention_pallas.py:80"),
             la_err, la_t["zeggs"], "q=k=v (1, 8, 88, 32) strided in, merged out, w=11", la_extra),
            ("encoder_layer", el_src, el_err["f32"], el_t["f32"],
             "x (1, 89, 256), H=4, F=1024, float32 (3xTF32)", {}),
            ("encoder_layer_bf16", el_src, el_err["bf16"], el_t["bf16"],
             "x (1, 89, 256), H=4, F=1024, mxu_bf16", {})):
        b2 = dict(ms=t[2]["ms"], plain_ms=t[2]["plain_ms"], library_ms=t[2]["library_ms"],
                  bound_ms=t[2]["bound"][0], bound_by=t[2]["bound"][1])
        b2.update({key: t[2][key] for key in la_keys[1:5] if key in t[2]})
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=e2e["ddpm1000"][f"{name}_launches"],
            max_abs_err=err, ms=t[1]["ms"], plain_ms=t[1]["plain_ms"],
            bound_ms=t[1]["bound"][0], bound_by=t[1]["bound"][1],
            library_ms=t[1]["library_ms"], shape=shape,
            launches_dpmpp5=e2e["dpmpp5"][f"{name}_launches"], b2=b2, **extra))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": e2e, "build_s": build_s}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
