"""Embedding components of the denoiser.

Port of `diffusestylegesture_tpu/models/embeddings.py` (reference
`main/model/mdm.py`: PositionalEncoding `:372-389`, TimestepEmbedder
`:434-448`, InputProcess `:451-475`, OutputProcess `:478-504`, WavEncoder
`:545-552`). Module and parameter names follow the reference so its
state_dict loads as it is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """The interleaved sin/cos table (ref `:377-382`), (L, D) float32."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class TimestepEmbedder(nn.Module):
    """PE lookup → Linear → SiLU → Linear (ref `:434-448`)."""

    def __init__(self, latent_dim: int, max_len: int = 5000):
        super().__init__()
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(), nn.Linear(latent_dim, latent_dim))
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_len, latent_dim)),
                             persistent=False)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps])


class InputProcess(nn.Module):
    """Per-frame linear pose embedding: (B, C, F, T) → (B, T, latent)."""

    def __init__(self, input_feats: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(input_feats, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, F, T = x.shape
        return self.poseEmbedding(x.permute(0, 3, 1, 2).reshape(B, T, C * F))


class OutputProcess(nn.Module):
    """Latent → pose features: (B, T, D) → (B, C, F, T)."""

    def __init__(self, input_feats: int, latent_dim: int, njoints: int, nfeats: int):
        super().__init__()
        self.njoints, self.nfeats = njoints, nfeats
        self.poseFinal = nn.Linear(latent_dim, input_feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        out = self.poseFinal(x).reshape(B, T, self.njoints, self.nfeats)
        return out.permute(0, 2, 3, 1)


class WavEncoder(nn.Module):
    """WavLM-feature projection 1024 → 64 (ref `:545-552`)."""

    def __init__(self, in_dim: int = 1024, out_dim: int = 64):
        super().__init__()
        self.audio_feature_map = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.audio_feature_map(x)


def mask_cond(cond: torch.Tensor, uncond: Optional[torch.Tensor] = None,
              drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classifier-free-guidance condition masking (ref `mask_cond:156-164`):
    rows where the per-example `uncond` flag (inference) or the training
    Bernoulli draw `drop` is set are zeroed; with both, either zeroes."""
    keep = None
    for flags in (uncond, drop):
        if flags is not None:
            k = 1.0 - flags.to(cond.dtype)[:, None]
            keep = k if keep is None else keep * k
    return cond if keep is None else cond * keep
