"""DiffWave-conditioned pose diffusion baseline (`diffwav_model`).

Port of `diffusestylegesture_tpu/models/diffwav.py`, the JAX package's
realization of the reference's `generate/diffwav.py:17-63` (which cannot
import: its `mydiffwave` package exists nowhere): the raw-audio `WavEncoder`
(B, 240, 32) conditioner and a DiffWave denoiser (Kong et al. 2021) over
(B, 240, 135) pose windows — a 1×1 input conv + ReLU, the 128-d step
embedding with two swish FCs to 512, residual layers of dilated k3 convs
(dilation 2^(i mod cycle)) gated tanh·sigmoid with a step bias and a 1×1
conditioner projection, skips summed and scaled by 1/sqrt(L), a two-conv
head with a zero-initialised last projection. The loss is SmoothL1 between
the prediction and the noise under DiffWave's continuous noise level; the
sampler is DiffWave's fast loop x ← (x − c2·ε)/sqrt(α_n) + σ_n·z (n > 0),
clamped to [−1, 1].

Tensors are (B, T, C) as in the JAX module; the convolutions run on the
(B, C, T) transpose. Every draw comes from a `torch.Generator` or is
injected. Plain PyTorch ops: no kernel computes this network.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .baselines import WavEncoder


def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """(B, T, C) through a Conv1d."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class DiffusionStepEmbedding(nn.Module):
    """sin/cos of t · 10^(4j/63), j < 64, then two swish FCs to `out_dim`."""

    def __init__(self, out_dim: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(128, out_dim)
        self.fc2 = nn.Linear(out_dim, out_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        j = torch.arange(64, dtype=torch.float32, device=t.device)
        ang = t.float()[:, None] * 10.0 ** (j[None, :] * 4.0 / 63.0)
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return F.silu(self.fc2(F.silu(self.fc1(emb))))


class DiffWaveResidualLayer(nn.Module):
    def __init__(self, residual_channels: int, cond_channels: int, dilation: int,
                 step_dim: int = 512):
        super().__init__()
        C = residual_channels
        self.dilated_conv = nn.Conv1d(C, 2 * C, 3, padding=dilation, dilation=dilation)
        self.step_proj = nn.Linear(step_dim, 2 * C)
        self.cond_proj = nn.Conv1d(cond_channels, 2 * C, 1)
        self.out_proj = nn.Conv1d(C, 2 * C, 1)

    def forward(self, x, temb, cond):
        y = _conv(x, self.dilated_conv) + self.step_proj(temb)[:, None, :] \
            + _conv(cond, self.cond_proj)
        gate, filt = y.chunk(2, dim=-1)
        residual, skip = _conv(torch.tanh(filt) * torch.sigmoid(gate), self.out_proj).chunk(2, -1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffWave1D(nn.Module):
    """forward(x (B, T, channels), t (B,), cond (B, T, cond_channels)) → ε (B, T, channels)."""

    def __init__(self, channels: int = 135, cond_channels: int = 32, residual_channels: int = 64,
                 residual_layers: int = 30, dilation_cycle: int = 10):
        super().__init__()
        self.input_proj = nn.Conv1d(channels, residual_channels, 1)
        self.step_embed = DiffusionStepEmbedding()
        self.layers = nn.ModuleList(
            DiffWaveResidualLayer(residual_channels, cond_channels, 2 ** (i % dilation_cycle))
            for i in range(residual_layers))
        self.skip_proj = nn.Conv1d(residual_channels, residual_channels, 1)
        self.output_proj = nn.Conv1d(residual_channels, channels, 1)
        nn.init.zeros_(self.output_proj.weight)
        nn.init.zeros_(self.output_proj.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = F.relu(_conv(x, self.input_proj))
        temb = self.step_embed(t)
        skip_sum = torch.zeros_like(h)
        for layer in self.layers:
            h, skip = layer(h, temb, cond)
            skip_sum = skip_sum + skip
        out = F.relu(_conv(skip_sum / math.sqrt(len(self.layers)), self.skip_proj))
        return _conv(out, self.output_proj)


class DiffWavModel(nn.Module):
    """`diffwav_model` (`diffwav.py:17-43`): `WavEncoder` + the DiffWave denoiser
    (module `diffwav_model`) over seq_len × channels pose windows."""

    def __init__(self, seq_len: int = 240, channels: int = 135, audio_dim: int = 32,
                 residual_channels: int = 64, residual_layers: int = 30,
                 dilation_cycle: int = 10):
        super().__init__()
        self.seq_len, self.channels = seq_len, channels
        self.WavEncoder = WavEncoder()
        self.diffwav_model = DiffWave1D(channels, audio_dim, residual_channels, residual_layers,
                                        dilation_cycle)

    def encode_audio(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, 64000) raw 16 kHz audio → (B, 240, 32) (`diffwav.py:25`)."""
        return self.WavEncoder(wav)

    def forward(self, x, t, cond):
        if cond.dim() == 2:  # raw audio
            cond = self.encode_audio(cond)
        return self.diffwav_model(x, t, cond)


def diffwav_beta_schedule(steps: int = 50, beta_end: float = 0.05) -> np.ndarray:
    """The reference's schedule: linspace(1e-4, beta_end, steps) (`diffwav.py:66`)."""
    return np.linspace(1e-4, beta_end, steps)


def diffwav_aligned_T(train_beta: np.ndarray, infer_beta: np.ndarray) -> np.ndarray:
    """DiffWave's fast-sampling alignment (Kong et al. 2021, App. B;
    `diffwav.py:80-96`): each inference noise level placed at a fractional
    training step by matching sqrt(alpha_cum)."""
    talpha_cum = np.sqrt(np.cumprod(1.0 - np.asarray(train_beta, np.float64)))
    alpha_cum = np.sqrt(np.cumprod(1.0 - np.asarray(infer_beta, np.float64)))
    T = np.zeros(len(infer_beta))
    for s in range(len(infer_beta)):
        for t in range(len(train_beta) - 1):
            if talpha_cum[t + 1] <= alpha_cum[s] <= talpha_cum[t]:
                T[s] = t + (talpha_cum[t] - alpha_cum[s]) / (talpha_cum[t] - talpha_cum[t + 1])
                break
    return T.astype(np.float32)


def _cond(model: DiffWavModel, wav: torch.Tensor) -> torch.Tensor:
    """A 2-D wav is raw audio; a 3-D one an already encoded conditioner."""
    return wav if wav.dim() == 3 else model.encode_audio(wav)


def diffwav_training_loss(model: DiffWavModel, pose: torch.Tensor, wav: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          beta: Optional[np.ndarray] = None, *,
                          t: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SmoothL1 between ε̂ and ε under the continuous noise level
    (`diffwav.py:40-43,70-77`); t, then the noise, drawn from `generator`
    unless given."""
    if beta is None:
        beta = diffwav_beta_schedule()
    B, dev = pose.shape[0], pose.device
    noise_level = torch.as_tensor(np.cumprod(1.0 - beta), dtype=torch.float32, device=dev)
    if t is None:
        t = torch.randint(0, len(beta), (B,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(pose.shape, generator=generator, device=dev)
    scale = noise_level[t][:, None, None]
    noisy = torch.sqrt(scale) * pose + torch.sqrt(1.0 - scale) * noise
    pred = model.diffwav_model(noisy, t.float(), _cond(model, wav))
    return F.smooth_l1_loss(pred, noise, beta=1.0)


@torch.no_grad()
def diffwav_sample(model: DiffWavModel, wav: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   beta: Optional[np.ndarray] = None, T: Optional[np.ndarray] = None, *,
                   x_T: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
                   clamp: bool = True) -> torch.Tensor:
    """The `diffwav_model.sample` loop (`diffwav.py:24-38`): (B, seq_len,
    channels). `x_T` and `step_noise` (steps, B, seq_len, channels; row i the
    noise of the i-th step taken, from n = steps − 1 down) replace the draws."""
    if beta is None:
        beta = diffwav_beta_schedule()
    if T is None:
        T = diffwav_aligned_T(beta, beta)
    beta = np.asarray(beta, np.float64)
    alpha_cum = np.cumprod(1.0 - beta)
    c1 = (1.0 / np.sqrt(1.0 - beta)).astype(np.float32)
    c2 = (beta / np.sqrt(1.0 - alpha_cum)).astype(np.float32)
    sigma = np.concatenate([[0.0], np.sqrt((1.0 - alpha_cum[:-1]) / (1.0 - alpha_cum[1:])
                                           * beta[1:])]).astype(np.float32)
    T = np.asarray(T, np.float32)
    B, dev = wav.shape[0], wav.device
    shape = (B, model.seq_len, model.channels)
    cond = _cond(model, wav)
    x = torch.randn(shape, generator=generator, device=dev) if x_T is None else x_T
    for i, n in enumerate(range(len(beta) - 1, -1, -1)):
        t = torch.full((B,), float(T[n]), device=dev)
        eps = model.diffwav_model(x, t, cond)
        x = float(c1[n]) * (x - float(c2[n]) * eps)
        noise = (torch.randn(shape, generator=generator, device=dev) if step_noise is None
                 else step_noise[i])
        x = x + (float(sigma[n]) if n > 0 else 0.0) * noise
        if clamp:
            x = x.clamp(-1.0, 1.0)
    return x
