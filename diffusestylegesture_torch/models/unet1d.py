"""Audio-conditioned 1-D U-Net diffusion baseline (`Generator_diff`).

Port of `diffusestylegesture_tpu/models/unet1d.py`, the JAX package's
intent-repaired realization of the reference's `Generator_diff`
(`main/mydiffusion_zeggs/generate/generate.py:350-385`, which cannot run:
its `myUnet1D` / `myGaussianDiffusion1D` exist nowhere): a lucidrains-shaped
1-D U-Net (sinusoidal time MLP, per-level ResNet blocks with FiLM time
conditioning and GroupNorm(8), strided-conv down, resize-conv up, attention
at the bottleneck, skip concatenation) with dim 64, mults (1, 2, 4, 8), 135
pose channels, self-conditioning and the 240 × 32 `WavEncoder` features
concatenated to its input, under a 250-step cosine Gaussian diffusion with
`pred_v` and the Huber loss (SmoothL1, β = 1).

Tensors are (B, T, C) as in the JAX module; the convolutions run on the
(B, C, T) transpose. flax's GroupNorm and LayerNorm epsilon (1e-6) and its
tanh-approximated `nn.gelu` in the time MLP are kept. Every draw of the loss
and the sampler comes from a `torch.Generator` or is injected, so a test can
replay the JAX draws. Plain PyTorch ops: no kernel computes this network.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion import gaussian as G
from ..diffusion.schedule import Schedule, named_beta_schedule
from .baselines import WavEncoder

EPS = 1e-6  # flax GroupNorm / LayerNorm


def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """(B, T, C) through a Conv1d."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class SinusoidalTimeEmbed(nn.Module):
    """dim-d sinusoidal t embedding → 4·dim MLP (lucidrains `Unet1D.time_mlp`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.fc1 = nn.Linear(dim, dim * 4)
        self.fc2 = nn.Linear(dim * 4, dim * 4)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half, dtype = self.dim // 2, self.fc1.weight.dtype
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, device=t.device, dtype=dtype) / (half - 1))
        ang = t.to(dtype)[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.fc2(F.gelu(self.fc1(emb), approximate="tanh"))


class ResBlock1D(nn.Module):
    """Two k3 convs with GroupNorm(8) + SiLU, FiLM scale-shift from the time
    embedding after the first norm, a 1×1 residual projection on a change of
    width."""

    def __init__(self, cin: int, features: int, temb_dim: int):
        super().__init__()
        self.conv1 = nn.Conv1d(cin, features, 3, padding=1)
        self.norm1 = nn.GroupNorm(8, features, eps=EPS)
        self.film = nn.Linear(temb_dim, 2 * features)
        self.conv2 = nn.Conv1d(features, features, 3, padding=1)
        self.norm2 = nn.GroupNorm(8, features, eps=EPS)
        self.res_proj = nn.Conv1d(cin, features, 1) if cin != features else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self.conv1(x.transpose(1, 2))).transpose(1, 2)
        scale, shift = self.film(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        h = F.silu(h * (scale + 1.0) + shift)
        h = F.silu(self.norm2(self.conv2(h.transpose(1, 2)))).transpose(1, 2)
        if self.res_proj is not None:
            x = _conv(x, self.res_proj)
        return x + h


class SelfAttention1D(nn.Module):
    """Full self-attention over the (coarse) time axis at the bottleneck."""

    def __init__(self, channels: int, heads: int = 4, head_dim: int = 32):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.norm = nn.LayerNorm(channels, eps=EPS)
        self.qkv = nn.Linear(channels, 3 * heads * head_dim, bias=False)
        self.out = nn.Linear(heads * head_dim, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        q, k, v = (a.reshape(B, T, self.heads, self.head_dim)
                   for a in self.qkv(self.norm(x)).chunk(3, dim=-1))
        att = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(self.head_dim),
                            dim=-1)
        out = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, -1)
        return x + self.out(out)


class UNet1D(nn.Module):
    """1-D U-Net denoiser: forward(x (B, T, channels), t (B,), audio_feat
    (B, T, audio_dim) or None, x_self_cond (B, T, channels) or None) → the
    v-prediction (B, T, channels). Submodule names are the JAX module's."""

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 135, self_condition: bool = True, audio_dim: int = 32):
        super().__init__()
        self.dim, self.dim_mults, self.channels = dim, tuple(dim_mults), channels
        self.self_condition, self.audio_dim = self_condition, audio_dim
        cin = channels * (2 if self_condition else 1) + audio_dim
        self.init_conv = nn.Conv1d(cin, dim, 7, padding=3)
        self.time_mlp = SinusoidalTimeEmbed(dim)
        E = dim * 4
        dims = [dim * m for m in self.dim_mults]
        blocks, convs = {}, {}
        prev = dim
        for i, d in enumerate(dims):
            blocks[f"down{i}_block1"] = ResBlock1D(prev, d, E)
            blocks[f"down{i}_block2"] = ResBlock1D(d, d, E)
            if i < len(dims) - 1:
                convs[f"down{i}_downsample"] = nn.Conv1d(d, d, 4, stride=2, padding=1)
            prev = d
        blocks["mid_block1"] = ResBlock1D(prev, dims[-1], E)
        blocks["mid_block2"] = ResBlock1D(dims[-1], dims[-1], E)
        self.mid_attn = SelfAttention1D(dims[-1])
        skip_widths = [dim] + dims
        h = dims[-1]
        for i in reversed(range(len(dims))):
            d = dims[i]
            blocks[f"up{i}_block1"] = ResBlock1D(h + skip_widths[i + 1], d, E)
            blocks[f"up{i}_block2"] = ResBlock1D(d, d, E)
            h = d
            if i > 0:
                convs[f"up{i}_upsample"] = nn.Conv1d(d, dims[i - 1], 3, padding=1)
                h = dims[i - 1]
        blocks["final_block"] = ResBlock1D(h + dim, dim, E)
        self.blocks = nn.ModuleDict(blocks)
        self.convs = nn.ModuleDict(convs)
        self.final_conv = nn.Conv1d(dim, channels, 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, audio_feat: Optional[torch.Tensor] = None,
                x_self_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        down = 2 ** (len(self.dim_mults) - 1)
        if T % down:
            raise ValueError(f"seq_len {T} must be a multiple of {down} "
                             "(2^(len(dim_mults)-1)) so the up-path skip shapes match")
        parts = [x]
        if self.self_condition:
            parts.append(torch.zeros_like(x) if x_self_cond is None else x_self_cond)
        if self.audio_dim:
            parts.append(x.new_zeros(B, T, self.audio_dim) if audio_feat is None else audio_feat)
        h = _conv(torch.cat(parts, dim=-1), self.init_conv)
        temb = self.time_mlp(t)
        b = self.blocks
        n = len(self.dim_mults)
        skips = [h]
        for i in range(n):
            h = b[f"down{i}_block2"](b[f"down{i}_block1"](h, temb), temb)
            skips.append(h)
            if i < n - 1:
                h = _conv(h, self.convs[f"down{i}_downsample"])
        h = b["mid_block2"](self.mid_attn(b["mid_block1"](h, temb)), temb)
        for i in reversed(range(n)):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = b[f"up{i}_block2"](b[f"up{i}_block1"](h, temb), temb)
            if i > 0:  # resize-conv upsample
                h = _conv(h.repeat_interleave(2, dim=1), self.convs[f"up{i}_upsample"])
        h = b["final_block"](torch.cat([h, skips.pop()], dim=-1), temb)
        return _conv(h, self.final_conv)


class GeneratorDiff(nn.Module):
    """`Generator_diff` (`generate.py:350-385`): the raw-audio `WavEncoder` +
    the audio-conditioned `UNet1D` (module `unet`)."""

    def __init__(self, seq_len: int = 240, joints: int = 15, n_dim: int = 9, audio_dim: int = 32,
                 dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8), timesteps: int = 250):
        super().__init__()
        self.seq_len, self.n_channels, self.timesteps = seq_len, joints * n_dim, timesteps
        self.WavEncoder = WavEncoder()
        self.unet = UNet1D(dim, dim_mults, self.n_channels, True, audio_dim)

    def encode_audio(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, 64000) raw 16 kHz audio → (B, 240, 32) (`generate.py:377-379`)."""
        return self.WavEncoder(wav)

    def forward(self, x, t, audio_feat, x_self_cond=None):
        if audio_feat.dim() == 2:  # raw audio
            audio_feat = self.encode_audio(audio_feat)
        return self.unet(x, t, audio_feat, x_self_cond)


def make_generator_diff_schedule(timesteps: int = 250, device="cuda") -> Schedule:
    """lucidrains `GaussianDiffusion1D`'s default for 1-D data: cosine betas, on
    the card unless the caller asks for the CPU (`Schedule.create` raises
    without one)."""
    return Schedule.create(named_beta_schedule("cosine", timesteps), device=device)


def _audio(model: GeneratorDiff, wav: torch.Tensor) -> torch.Tensor:
    """A 2-D wav is raw audio; a 3-D one an already encoded conditioner."""
    return wav if wav.dim() == 3 else model.encode_audio(wav)


def generator_diff_loss(model: GeneratorDiff, sched: Schedule, pose: torch.Tensor,
                        wav: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                        t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                        use_sc: Optional[bool] = None) -> torch.Tensor:
    """The training loss (JAX `generator_diff_loss`): q_sample, self-conditioning
    on a coin flip (a no-grad x0 estimate fed back), Huber(v_pred, v_target)
    per example, weighted by snr / (snr + 1), mean. t, the noise and the coin
    are drawn from `generator` in that order unless given."""
    B, dev = pose.shape[0], pose.device
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (B,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(pose.shape, generator=generator, device=dev)
    if use_sc is None:
        use_sc = bool(torch.rand((), generator=generator, device=dev) < 0.5)
    x_t = G.q_sample(sched, pose, t, noise)
    audio_feat = _audio(model, wav)
    x_sc = torch.zeros_like(x_t)
    if use_sc:
        with torch.no_grad():
            x_sc = G.predict_xstart_from_v(sched, x_t, t, model.unet(x_t, t, audio_feat, None))
    v_pred = model.unet(x_t, t, audio_feat, x_sc)
    v_target = G.predict_v(sched, pose, t, noise)
    per_ex = G.smooth_l1(v_pred, v_target).mean(dim=tuple(range(1, pose.dim())))
    snr = sched.alphas_cumprod[t] / (1.0 - sched.alphas_cumprod[t])
    return torch.mean(per_ex * (snr / (snr + 1.0)))


@torch.no_grad()
def generator_diff_sample(model: GeneratorDiff, sched: Schedule, wav: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          x_T: Optional[torch.Tensor] = None,
                          step_noise: Optional[torch.Tensor] = None,
                          clip_denoised: bool = True) -> torch.Tensor:
    """Ancestral sampling with the x0 estimate carried as self-conditioning
    (`Generator_diff.sample`): (B, seq_len, n_channels). `x_T` and
    `step_noise` (num_timesteps, B, seq_len, n_channels; row i is the noise of
    the i-th step taken, from t = T − 1 down) replace the draws."""
    B, dev = wav.shape[0], wav.device
    shape = (B, model.seq_len, model.n_channels)
    audio_feat = _audio(model, wav)
    img = torch.randn(shape, generator=generator, device=dev) if x_T is None else x_T
    x_sc = torch.zeros_like(img)
    for i, step in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((B,), step, dtype=torch.long, device=dev)
        v = model.unet(img, t, audio_feat, x_sc)
        out = G.p_mean_variance(sched, v, img, t, mean_type=G.MeanType.VELOCITY,
                                var_type=G.VarType.FIXED_SMALL, clip_denoised=clip_denoised)
        noise = (torch.randn(shape, generator=generator, device=dev) if step_noise is None
                 else step_noise[i])
        img = out.mean + (float(step != 0) * torch.exp(0.5 * out.log_variance)) * noise
        x_sc = out.pred_xstart
    return img
