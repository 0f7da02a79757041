"""DiffuseStyleGesture+ on TWH, GENEA 2023 (reference `BEAT-TWH-main/model/mdm.py`,
`cond_mode='cross_local_attention4_style1'`, sizes of `end2end.py:90-99`;
`mydiffusion_beat_twh/sample.py:44-201`), plain float32 PyTorch.

Denoiser: token = speaker emb (latent-wide) + timestep emb; each of the
n_seed seed frames is projected to the feature width and put in front of the
window's projected text+audio features along time; frames = Linear([token |
pose emb | those features]) → RoPE over 8 heads → causal local attention
(window 15) → [token ; frames] → RoPE over the same 8 heads → 8 post-norm
encoder layers of 4 heads → Linear back to the 2232 pose features.

Long-form sampling: ⌈T / stride⌉ windows over the zero-padded features, each
fed its own stride of them; window 0 is seeded with the given seed gesture,
later windows with the previous sample's last n_seed frames, crossfaded over
the batch-size-wide band (the reference's batch-axis quirk) without a root
correction; every window but the last keeps its stride, the last is kept
whole, the first n_seed frames are dropped and the position block (the first
third of the channels) is kept.
"""
from __future__ import annotations

import torch

from . import diffusion
from .layers import (Precision, no_tf32, Weights, linear, linear_layout, local_then_trunk,
                     sinusoidal_table, timestep_embedding, trunk_layout)


def layout(cfg: dict) -> list:
    """(name, shape, fan_in, offset) of the denoiser's weights, by the upstream names."""
    D, C, A = cfg["latent_dim"], cfg["njoints"], cfg["audio_feat_dim"]
    return (linear_layout("embed_timestep.time_embed.0", D, D)
            + linear_layout("embed_timestep.time_embed.2", D, D)
            + linear_layout("embed_style", D, cfg["style_dim_in"])
            + linear_layout("embed_text", A, C)
            + linear_layout("WavEncoder.audio_feature_map", A, cfg["source_audio_dim"])
            + linear_layout("input_process.poseEmbedding", D, C)
            + linear_layout("input_process2", D, 2 * D + A)
            + trunk_layout(cfg) + linear_layout("output_process.poseFinal", C, D))


class Twh:
    def __init__(self, cfg: dict, mdm: Weights, device, precision: str = "float32"):
        self.cfg, self.w, self.device = cfg, mdm, device
        self.p = Precision(precision)
        no_tf32()
        self.table = sinusoidal_table(cfg["diffusion_steps"], cfg["latent_dim"], device)

    def denoise(self, x, t, style, seed, audio) -> torch.Tensor:
        w, p, B = self.w, self.p, x.shape[0]
        token = linear(style, w, "embed_style", p) + timestep_embedding(t, self.table, w, p)
        enc = torch.cat([linear(seed[:, :, 0].transpose(1, 2), w, "embed_text", p),
                         linear(audio, w, "WavEncoder.audio_feature_map", p)], dim=1)
        frames = x[:, :, 0].transpose(1, 2)
        T = frames.shape[1]
        cat = torch.cat([token[:, None].expand(B, T, token.shape[-1]),
                         linear(frames, w, "input_process.poseEmbedding", p), enc], dim=-1)
        return local_then_trunk(token, cat, w, self.cfg, p).transpose(1, 2)[:, :, None]

    def sample(self, textaudio: torch.Tensor, seed_gesture: torch.Tensor, style: torch.Tensor,
               seed_int: int, sampler: str, sched) -> torch.Tensor:
        """textaudio (T, A), seed_gesture (n_seed, njoints), style (1, speakers) →
        normalized position block (T, njoints / 3) of a batch of one."""
        cfg, dev = self.cfg, self.device
        C, ns = cfg["njoints"], cfg["n_seed"]
        stride = cfg["n_poses"] - ns
        real = textaudio.shape[0]
        num = max(1, -(-real // stride))
        feats = torch.zeros(num * stride, textaudio.shape[1], device=dev)
        feats[:real] = textaudio
        feats = feats.reshape(num, stride, -1)
        gen = torch.Generator(device=dev).manual_seed(seed_int)
        wa, wb = diffusion.crossfade_weights(ns, 1, dev)
        seed = seed_gesture.T[None, :, None, :]
        samples = []
        for i in range(num):
            audio = feats[i][None]
            sample = diffusion.SAMPLERS[sampler](
                lambda x, t: self.denoise(x, t, style, seed, audio), sched,
                (1, C, 1, cfg["n_poses"]), slice(None), gen, dev)
            if i > 0:
                sample = torch.cat([seed * wa + sample[..., :ns] * wb, sample[..., ns:]], dim=-1)
            seed = sample[..., -ns:]
            samples.append(sample)
        keep = C // cfg["motion_feature_division"]
        parts = [s[0, :keep, 0, :stride] for s in samples[:-1]] + [samples[-1][0, :keep, 0]]
        return torch.cat(parts, dim=-1).T[ns:][:real]
