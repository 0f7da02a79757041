"""DiffuseStyleGesture on ZEGGS (reference `main/model/mdm.py`,
`cond_mode='cross_local_attention3_style1'`, `audio_feat='wavlm'`;
`main/mydiffusion_zeggs/sample.py`), plain float32 PyTorch.

Denoiser: token = [style emb (64) | seed emb (latent − 64)] + timestep emb;
frames = Linear([token | pose emb | WavLM feature emb]) → RoPE over 8 heads
→ causal local attention (window 11) → [token ; frames] → RoPE over the same
8 heads → 8 post-norm encoder layers of 4 heads → Linear back to the 1141 pose features.

Long-form sampling (`sample.py:210-338`): the audio is cut into windows of
one stride with the previous window's last n_seed frames of audio in front
(zeros for window 0); WavLM-Large runs over every window and is
interpolated to n_poses frames; each window is sampled from its carried seed
(zeros for window 0), then (after window 0) the root-translation delta to
the seed is removed and the first n_seed frames crossfaded with it; every
window keeps its first stride, the warm-up seed frames are dropped.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import diffusion, wavlm
from .layers import (Precision, no_tf32, Weights, interpolate_frames, linear, linear_layout,
                     local_then_trunk, sinusoidal_table, timestep_embedding, trunk_layout)


def layout(cfg: dict) -> list:
    """(name, shape, fan_in, offset) of the denoiser's weights, by the upstream names."""
    D, C, A = cfg["latent_dim"], cfg["njoints"], cfg["audio_feat_dim"]
    return (linear_layout("embed_timestep.time_embed.0", D, D)
            + linear_layout("embed_timestep.time_embed.2", D, D)
            + linear_layout("embed_style", cfg["style_dim"], cfg["style_dim_in"])
            + linear_layout("embed_text", D - cfg["style_dim"], C * cfg["n_seed"])
            + linear_layout("WavEncoder.audio_feature_map", A, cfg["audio_in_dim"])
            + linear_layout("input_process.poseEmbedding", D, C)
            + linear_layout("input_process2", D, 2 * D + A)
            + trunk_layout(cfg) + linear_layout("output_process.poseFinal", C, D))


def slice_windows(audio: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(S,) audio → (num, seed samples + stride samples) windows."""
    sps = cfg["stride"] * cfg["sr"] // cfg["fps"]
    spd = cfg["n_seed"] * cfg["sr"] // cfg["fps"]
    num = audio.shape[0] // sps
    main = audio[: num * sps].reshape(num, sps)
    prev = torch.zeros(num, spd, dtype=audio.dtype, device=audio.device)
    prev[1:] = main[:-1, -spd:]
    return torch.cat([prev, main], dim=1)


class Zeggs:
    def __init__(self, cfg: dict, mdm: Weights, wavlm_weights: Weights, device,
                 precision: str = "float32"):
        self.cfg, self.w, self.wavlm_w, self.device = cfg, mdm, wavlm_weights, device
        self.p = Precision(precision)
        no_tf32()
        self.table = sinusoidal_table(cfg["diffusion_steps"], cfg["latent_dim"], device)

    def features(self, windows: torch.Tensor, block: int = 16) -> torch.Tensor:
        """(N, S) audio windows → (N, n_poses, 1024) WavLM features, `block` windows at a time."""
        out = [interpolate_frames(wavlm.forward(self.wavlm_w, self.cfg["wavlm"], windows[i:i + block],
                                                self.p), self.cfg["n_poses"])
               for i in range(0, windows.shape[0], block)]
        return torch.cat(out)

    def denoise(self, x, t, style, seed, audio) -> torch.Tensor:
        """x (B, njoints, 1, T), t (B,) → x0 prediction, same shape."""
        w, p, B = self.w, self.p, x.shape[0]
        token = torch.cat([linear(style, w, "embed_style", p),
                           linear(seed.reshape(B, -1), w, "embed_text", p)], dim=-1)
        token = token + timestep_embedding(t, self.table, w, p)
        frames = x[:, :, 0].transpose(1, 2)
        T = frames.shape[1]
        cat = torch.cat([token[:, None].expand(B, T, token.shape[-1]),
                         linear(frames, w, "input_process.poseEmbedding", p),
                         linear(audio, w, "WavEncoder.audio_feature_map", p)], dim=-1)
        return local_then_trunk(token, cat, w, self.cfg, p).transpose(1, 2)[:, :, None]

    def sample(self, feats: torch.Tensor, style: torch.Tensor, seed_int: int, full_batch: int,
               rows: Sequence[int], num_windows: int, sampler: str, sched,
               crossfade_n: int) -> torch.Tensor:
        """The window loop for `rows` of a batch of `full_batch` sampled under
        generator seed `seed_int`: feats (R, W, n_poses, 1024), style (R, 6).
        Returns the normalized poses (R, num_windows·stride − n_seed, njoints)."""
        cfg, dev = self.cfg, self.device
        C, ns, stride = cfg["njoints"], cfg["n_seed"], cfg["stride"]
        gen = torch.Generator(device=dev).manual_seed(seed_int)
        full = (full_batch, C, 1, cfg["n_poses"])
        rows = list(rows)
        wa, wb = diffusion.crossfade_weights(ns, crossfade_n, dev)
        seed = torch.zeros(len(rows), C, 1, ns, device=dev)
        pieces = []
        for i in range(num_windows):
            audio = feats[:, i]
            sample = diffusion.SAMPLERS[sampler](
                lambda x, t: self.denoise(x, t, style, seed, audio), sched, full, rows, gen, dev)
            if i > 0:
                delta = (sample[:, 0:3, :, 0] - seed[:, 0:3, :, 0])[..., None]
                sample = torch.cat([sample[:, 0:3] - delta, sample[:, 3:]], dim=1)
                sample = torch.cat([seed * wa + sample[..., :ns] * wb, sample[..., ns:]], dim=-1)
            seed = sample[..., -ns:]
            pieces.append(sample[..., :stride])
        return torch.cat(pieces, dim=-1)[..., ns:][:, :, 0].transpose(1, 2)
