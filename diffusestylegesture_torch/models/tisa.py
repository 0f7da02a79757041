"""Translation-invariant self-attention positional scores (TISA).

Port of `diffusestylegesture_tpu/models/tisa.py` (reference
`main/model/tisa.py:8-107`, Wennberg & Henter 2021): per-head radial-basis
scores over the relative offsets −T..T, expanded into a Toeplitz (H, T, T)
additive attention bias by one gather with the reference's index
arithmetic. A standalone bias module: in the reference only the unrunnable
`mytrans_enc` arch reaches it. Plain PyTorch ops (no kernel computes it).
"""
from __future__ import annotations

import torch
from torch import nn


class Tisa(nn.Module):
    """`Tisa(num_attention_heads, num_kernels)(seq_len)` → (H, T, T) scores.
    Parameters (K, H): `kernel_offsets`, `kernel_amplitudes`,
    `kernel_sharpness`, initialised as the JAX module's."""

    def __init__(self, num_attention_heads: int = 12, num_kernels: int = 5):
        super().__init__()
        self.num_attention_heads, self.num_kernels = num_attention_heads, num_kernels
        shape = (num_kernels, num_attention_heads)
        self.kernel_offsets = nn.Parameter(5.0 * torch.randn(shape))
        self.kernel_amplitudes = nn.Parameter(0.1 + 0.01 * torch.randn(shape))
        self.kernel_sharpness = nn.Parameter(0.1 + 0.01 * torch.randn(shape))

    def positional_scores(self, offsets: torch.Tensor) -> torch.Tensor:
        """RBF scores per head over relative offsets (ref `:30-41`): (H, len(offsets))."""
        d = self.kernel_offsets[..., None] - offsets
        rbf = self.kernel_amplitudes[..., None] * torch.exp(
            -self.kernel_sharpness[..., None].abs() * d ** 2)
        return rbf.sum(dim=0)

    def forward(self, seq_len: int) -> torch.Tensor:
        H, dev = self.num_attention_heads, self.kernel_offsets.device
        if not self.num_kernels:
            return torch.zeros(H, seq_len, seq_len, device=dev)
        offsets = torch.arange(-seq_len, seq_len + 1, device=dev, dtype=torch.float32)
        scores = self.positional_scores(offsets)  # (H, 2T+1)
        # Toeplitz expansion with the reference's index arithmetic (ref `:43-61`)
        idx = (torch.arange(0, -(seq_len ** 2), -1, device=dev) + (seq_len - 1)).reshape(
            seq_len, seq_len) + (seq_len + 1) * torch.arange(seq_len, device=dev)[:, None]
        return scores[:, idx.reshape(-1)].reshape(H, seq_len, seq_len)
