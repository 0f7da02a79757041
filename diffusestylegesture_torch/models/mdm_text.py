"""Text-conditioned MDM denoiser (MDM-legacy text-to-motion).

Port of `diffusestylegesture_tpu/models/mdm_text.py` (the reference's
`MDM(cond_mode='text')` branch, `main/model/mdm.py`, which the gesture fork
stripped; the JAX package restored it):

  x_t (B, njoints, 1, T) hml_vec -> InputProcess -> prepend the
  [t_embed + embed_text(mask_cond(clip_features))] token -> additive
  sinusoidal positions -> trans_enc trunk -> drop the token -> OutputProcess.

The trunk is the port's `TorchTransformerEncoder`: with ``impl='kernel'``
each dense layer runs kernel B on a CUDA tensor (at HumanML3D's T = 197 and
head dim 128 through its key-tiled attention grid, `ops/encoder_layer.py`);
``impl='plain'`` runs the plain layer everywhere (training, the comparison
path). ``dtype=torch.bfloat16`` is kernel B's `mxu_bf16` mode, as in
`models/mdm.py`. HumanML3D defaults: njoints 263, latent 512, 8 layers, ff
1024, 4 heads (`main/utils/parser_util.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel import draws
from .embeddings import InputProcess, OutputProcess, TimestepEmbedder, mask_cond, sinusoidal_pe
from .mdm import trunk_pipe, validate_parallel
from .transformer import TorchTransformerEncoder


@dataclasses.dataclass(frozen=True)
class TextMDMConfig:
    njoints: int = 263  # HumanML3D hml_vec; KIT 251
    nfeats: int = 1
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    clip_dim: int = 512
    cond_mask_prob: float = 0.1
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    # the trunk's parallel fields of `MDMConfig` (models/mdm.py)
    trunk_impl: str = "loop"
    pipe_mesh: object = None
    pipe_axis: str = "pipe"
    pipe_microbatches: int = 0
    remat: bool = False
    split_qkv: bool = False
    impl: str = "kernel"
    dtype: torch.dtype = torch.float32

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    def validate(self) -> None:
        validate_parallel(self)
        if self.impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, not {self.dtype}")


class TextMDM(nn.Module):
    """forward(x, timesteps, cond, uncond=None, train=False, generator=None, cond_drop=None)

    x: (B, njoints, nfeats, T) noisy hml_vec; timesteps: (B,) int;
    cond: {'text_emb': (B, clip_dim)} CLIP text features; uncond: optional
    (B,) bool CFG drop. train: the training forward (impl='plain'): a
    Bernoulli(cond_mask_prob) drop of the text per example, then dropout in
    the trunk, drawn from `generator` (`cond_drop`, a (B,) bool, replaces the
    draw). Returns the x0 prediction (B, njoints, nfeats, T); a train forward
    with moe_experts > 0 returns (prediction, mean load-balance loss).
    """

    def __init__(self, cfg: TextMDMConfig = TextMDMConfig()):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        D = cfg.latent_dim
        self.embed_timestep = TimestepEmbedder(D)
        self.embed_text = nn.Linear(cfg.clip_dim, D)
        self.input_process = InputProcess(cfg.input_feats, D)
        self.seqTransEncoder = TorchTransformerEncoder(
            cfg.num_layers, D, cfg.num_heads, cfg.ff_size, cfg.activation, cfg.dropout,
            cfg.moe_experts, cfg.moe_capacity_factor, cfg.split_qkv)
        self.output_process = OutputProcess(cfg.input_feats, D, cfg.njoints, cfg.nfeats)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(5000, D)), persistent=False)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, torch.Tensor],
                uncond: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cond_drop: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, _, _, T = x.shape
        if train and cfg.impl != "plain":
            raise ValueError("train=True needs TextMDMConfig(impl='plain'): kernel B has no "
                             "backward, as the Pallas kernel has none")
        drop = None
        if train:
            drop = cond_drop if cond_drop is not None else (
                draws.rand((B,), generator, x.device) < cfg.cond_mask_prob
                if cfg.cond_mask_prob > 0.0 else None)
        text = mask_cond(cond["text_emb"], uncond, drop)
        token = self.embed_timestep(timesteps) + self.embed_text(text)    # (B, D)
        seq = torch.cat([token[:, None, :], self.input_process(x)], dim=1)
        seq = (seq + self.pe[: T + 1]).contiguous()
        aux = [] if train and cfg.moe_experts else None
        out = self.seqTransEncoder(seq, impl=cfg.impl, mxu_bf16=cfg.dtype == torch.bfloat16,
                                   train=train, generator=generator, aux=aux,
                                   pipe=trunk_pipe(cfg))[:, 1:]
        out = self.output_process(out)
        if aux is not None:
            return out, torch.stack(aux).mean()
        return out


def make_t2m_cond_builder():
    """A text-to-motion batch -> (x_start, cond, mask) for
    `train/state.py::make_train_step`.

    batch: {'motion' (B, T, njoints), 'text_emb' (B, clip_dim), 'lengths'
    (B,) int}, the `t2m_collate` layout with each caption replaced by its
    CLIP embedding. The loss mask keeps each clip's real frames
    (`lengths_to_mask`, reference `main/data_loaders/tensors.py:2-23`)."""

    def builder(batch: Dict):
        motion = batch["motion"].transpose(1, 2)[:, :, None, :]  # (B, C, 1, T)
        T = motion.shape[-1]
        cond = {"text_emb": batch["text_emb"]}
        lengths = batch["lengths"]
        mask = (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]).to(
            torch.float32)[:, None, None, :]
        return motion, cond, mask

    return builder
