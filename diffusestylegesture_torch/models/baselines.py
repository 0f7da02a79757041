"""Baseline (non-diffusion) gesture generators of the reference.

Port of `diffusestylegesture_tpu/models/baselines.py` (reference
`main/mydiffusion_zeggs/generate/generate.py`):

  * `WavEncoder` (`generate.py:9-28`): four strided Conv1d, BatchNorm1d and
    LeakyReLU(0.3) after the first three, (B, 64000) → (B, 240, 32);
  * `GeneratorLinear` (`:31-57`): LayerNorm → Linear(32 → 512, no bias)
    codebook logits, cross-entropy, argmax `sample`;
  * `GeneratorGRU` (`:311-347`): 2-layer bidirectional GRU, the directions
    summed → LayerNorm → Linear(200 → 512);
  * `Seq2SeqNet` (`:64-307`): embedding + bidirectional GRU encoder (summed
    directions), Bahdanau additive attention, pre-linear with BatchNorm1d,
    GRU decoder cell, teacher-forced for `n_pre_poses` frames.

Module and parameter names are the reference's, so its state_dicts load
as they are (`load_reference_baseline`, the counterpart of the JAX
`convert_*`). BatchNorm is torch's: in eval mode it normalizes with the
running statistics, as the JAX modules do; in train mode with the batch's,
updating the running ones with momentum 0.1 and the unbiased variance
(flax `nn.BatchNorm(momentum=0.9)` keeps the biased one). The GRUs are
torch's `nn.GRU`, whose parameterization the JAX `TorchGRU` copies. The
baselines run their plain ops: no kernel of the port computes them.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


class WavEncoder(nn.Module):
    """(B, 64000) raw 16 kHz audio → (B, 240, 32) features (`generate.py:9-28`)."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (cin, cout, stride, pad) in enumerate(
                ((1, 16, 3, 800), (16, 32, 3, 0), (32, 64, 5, 0), (64, 32, 6, 0))):
            layers.append(nn.Conv1d(cin, cout, 15, stride=stride, padding=pad))
            if i < 3:
                layers += [nn.BatchNorm1d(cout), nn.LeakyReLU(0.3)]
        self.feat_extractor = nn.Sequential(*layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.feat_extractor(wav[:, None]).transpose(1, 2)


def _codebook_loss(logits: torch.Tensor, target: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if target is None:
        return None
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), target.reshape(-1))


class GeneratorLinear(nn.Module):
    """Codebook-logit baseline: forward(wav, target=None) → (logits (B, 240, 512), loss)."""

    def __init__(self, codebook_size: int = 512):
        super().__init__()
        self.WavEncoder = WavEncoder()
        self.norm = nn.LayerNorm(32, eps=1e-5)
        self.project = nn.Linear(32, codebook_size, bias=False)

    def forward(self, wav: torch.Tensor, target: Optional[torch.Tensor] = None):
        logits = self.project(self.norm(self.WavEncoder(wav)))
        return logits, _codebook_loss(logits, target)

    @torch.no_grad()
    def sample(self, wav: torch.Tensor) -> torch.Tensor:
        """The argmax codes, (B, 240)."""
        return self(wav)[0].argmax(dim=-1)


class GeneratorGRU(nn.Module):
    """Bidirectional-GRU codebook baseline: forward(wav, target=None) → (logits, loss)."""

    def __init__(self, hidden_size: int = 200, codebook_size: int = 512):
        super().__init__()
        self.hidden_size = hidden_size
        self.WavEncoder = WavEncoder()
        self.project = nn.GRU(32, hidden_size, 2, batch_first=True, bidirectional=True)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-5)
        self.out = nn.Linear(hidden_size, codebook_size)

    def forward(self, wav: torch.Tensor, target: Optional[torch.Tensor] = None):
        ys = self.project(self.WavEncoder(wav))[0]
        H = self.hidden_size
        logits = self.out(self.norm(ys[..., :H] + ys[..., H:]))
        return logits, _codebook_loss(logits, target)

    @torch.no_grad()
    def sample(self, wav: torch.Tensor) -> torch.Tensor:
        """The argmax codes, (B, 240)."""
        return self(wav)[0].argmax(dim=-1)


class EncoderRNN(nn.Module):
    """Embedding + bidirectional GRU, summed directions (`generate.py:64-108`):
    tokens (B, T) → (outputs (B, T, H), final states (2, B, H) forward, backward)."""

    def __init__(self, vocab: int, embed_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.embedding = nn.Embedding(vocab, embed_size)
        self.gru = nn.GRU(embed_size, hidden_size, 1, batch_first=True, bidirectional=True)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ys, h_last = self.gru(self.embedding(tokens))
        H = self.hidden_size
        return ys[..., :H] + ys[..., H:], h_last


class BahdanauAttn(nn.Module):
    """Additive attention (`generate.py:111-142`): (hidden (B, H), enc (B, T, H))
    → weights (B, 1, T)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.attn = nn.Linear(2 * hidden_size, hidden_size)
        self.v = nn.Parameter(torch.randn(hidden_size) / hidden_size ** 0.5)

    def forward(self, hidden: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        energy = torch.tanh(self.attn(torch.cat([hidden[:, None].expand_as(enc), enc], dim=-1)))
        return torch.softmax(energy @ self.v, dim=1)[:, None, :]


class BahdanauAttnDecoderCell(nn.Module):
    """One decoder step (`generate.py:145-240`, continuous representation):
    (motion_in (B, D), last_hidden (1, B, H), enc (B, T, H)) → (out (B, D_out),
    hidden (1, B, H), attention weights (B, 1, T))."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.attn = BahdanauAttn(hidden_size)
        self.pre_linear = nn.Sequential(nn.Linear(input_size + hidden_size, hidden_size),
                                        nn.BatchNorm1d(hidden_size), nn.ReLU())
        self.gru = nn.GRU(hidden_size, hidden_size, 1, batch_first=True)
        self.out = nn.Linear(hidden_size, output_size)

    def forward(self, motion_in: torch.Tensor, last_hidden: torch.Tensor, enc: torch.Tensor):
        attn_w = self.attn(last_hidden[-1], enc)
        context = (attn_w @ enc)[:, 0]
        h = self.pre_linear(torch.cat([motion_in, context], dim=-1))
        _, new_h = self.gru(h[:, None], last_hidden[-1:].contiguous())
        return self.out(new_h[0]), new_h, attn_w


class _Generator(nn.Module):
    """The reference's decoder wrapper: `decoder.decoder.*` in its state_dict."""

    def __init__(self, cell: BahdanauAttnDecoderCell):
        super().__init__()
        self.decoder = cell


class Seq2SeqNet(nn.Module):
    """Teacher-forced seq2seq baseline (`generate.py:272-307`): forward(tokens
    (B, T_text), poses (B, n_frames, pose_dim)) → (B, n_frames, pose_dim); the
    first `n_pre_poses` inputs are the teacher's frames, the rest its own."""

    def __init__(self, vocab: int, embed_size: int, hidden_size: int, pose_dim: int,
                 n_frames: int, n_pre_poses: int = 2):
        super().__init__()
        self.n_frames, self.n_pre_poses = n_frames, n_pre_poses
        self.encoder = EncoderRNN(vocab, embed_size, hidden_size)
        self.decoder = _Generator(BahdanauAttnDecoderCell(pose_dim, hidden_size, pose_dim))

    def forward(self, tokens: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
        enc, h_last = self.encoder(tokens)
        hidden = h_last[:1]  # the forward direction's final state (ref `:295`)
        outputs = [poses[:, 0]]
        dec_in = poses[:, 0]
        for t in range(1, self.n_frames):
            out, hidden, _ = self.decoder.decoder(dec_in, hidden, enc)
            outputs.append(out)
            dec_in = poses[:, t] if t < self.n_pre_poses else out
        return torch.stack(outputs, dim=1)


def load_reference_baseline(model: nn.Module,
                            state_dict: Union[str, Mapping[str, torch.Tensor]]) -> nn.Module:
    """A reference baseline's state_dict (or a `.pt` holding it) into the port's
    module of the same class: the names are the reference's, so every key the
    module has must be there (the JAX `convert_generator_linear`,
    `convert_generator_gru` and `convert_seq2seq` in one)."""
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    if missing:
        raise KeyError(f"reference baseline lacks {len(missing)} keys, e.g. {missing[:5]}")
    model.load_state_dict({k: state_dict[k] for k in own})
    return model
