"""MDM+ / MDM++ denoiser (DiffuseStyleGesture+/++ on BEAT and TWH).

Port of `diffusestylegesture_tpu/models/mdm_plus.py` (reference
`BEAT-TWH-main/model/mdm.py:10-267`):

* style = speaker one-hot (2 BEAT / 17 TWH) through `embed_style`;
* the audio input is the fused 1434/1435-d text+audio per-frame feature,
  projected by `WavEncoder` Linear(source_audio_dim → audio_feat_dim);
* window 15, 8 local/rotary heads;
* three conditioning variants:
    - `cross_local_attention3` ("DiffuseStyleGesture"): token = style(64) ⊕
      seed embedding, the audio spans all T frames;
    - `cross_local_attention4` ("+"): the style embedding is latent-wide; the
      n_seed seed frames are each projected Linear(njoints → audio_feat_dim)
      and prepended along time to the (T − n_seed)-frame audio features;
    - `cross_local_attention5` ("++"): as 4, plus a `seed_last` block
      projected by `embed_text_last` and appended at the end.
  In variants 4 and 5 only the style embedding passes through `mask_cond`
  (CFG's `uncond` and the training drop); the seed path is never dropped.

As in `MDM`, `cond_invariants` computes the embeddings that depend on the
conditioning alone, and `forward` reads them from a `cond` that holds them.

The local block and the trunk are the ZEGGS `MDM`'s (`models/mdm.py`): the
local attention runs kernel A and each trunk layer kernel B on a CUDA tensor
(`impl="kernel"`), their plain PyTorch versions with `impl="plain"`.
`moe_experts > 0` swaps every trunk layer's FFN for the Switch-routed
`models/moe.py::MoEFeedForward` (JAX `mdm_plus.py:76-78`); those layers run
their plain ops (kernel B computes a dense FFN).
`dtype=torch.bfloat16` is the serving mode (kernel B's `mxu_bf16` mode, the
rest float32), as in `MDM`. `train=True` is the training forward (per-example
drops of the style, and of the seed in variant 3, then dropout in the trunk),
which needs `impl="plain"`: neither kernel has a backward. Parameter names
are the reference module's, so a reference BEAT/TWH state_dict loads with
`load_state_dict` (`models/convert.py::load_reference_mdm_plus`). The
parallel fields (split q/k/v, pipelined trunk, sequence-parallel local
attention) are `MDMConfig`'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .embeddings import InputProcess, OutputProcess, TimestepEmbedder, WavEncoder, mask_cond
from ..parallel import draws
from .mdm import (local_block, seed_embedding, seq_group, style_embedding, trunk, trunk_pipe,
                  validate_parallel)
from .transformer import TorchTransformerEncoder

VARIANTS = ("cross_local_attention3", "cross_local_attention4", "cross_local_attention5")


@dataclasses.dataclass(frozen=True)
class MDMPlusConfig:
    njoints: int = 2232  # TWH (2052 BEAT v0): motion · 3 (position, velocity, acceleration)
    nfeats: int = 1
    latent_dim: int = 512  # 384 BEAT
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    local_heads: int = 8
    dropout: float = 0.1  # the trunk's, in train mode
    activation: str = "gelu"
    source_audio_dim: int = 1435  # 1434 BEAT (audio 1133 + text 301/302)
    audio_feat_dim: int = 128  # 96 BEAT
    style_dim_in: int = 17  # speakers (2 BEAT)
    style_dim: int = 64  # attention3 only; 4 and 5 embed the style latent-wide
    n_seed: int = 30
    cond_mode: str = "cross_local_attention4_style1"
    cond_mask_prob: float = 0.1
    window_size: int = 15
    # >0: a Switch-routed MoE FFN in every trunk layer (`models/moe.py`)
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    # the parallel fields of `MDMConfig` (models/mdm.py)
    trunk_impl: str = "loop"
    pipe_mesh: object = None
    pipe_axis: str = "pipe"
    pipe_microbatches: int = 0
    remat: bool = False
    split_qkv: bool = False
    seq_parallel: bool = False
    seq_mesh: object = None
    seq_axis: str = "seq"
    # "kernel": the CUDA kernels on CUDA tensors; "plain": the plain versions
    impl: str = "kernel"
    # torch.float32, or torch.bfloat16: the trunk's matmul operands in bf16
    dtype: torch.dtype = torch.float32

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    @property
    def variant(self) -> str:
        """The cond mode's variant: 'cross_local_attention3', 4 or 5."""
        return next(v for v in VARIANTS if self.cond_mode.startswith(v))

    def validate(self) -> None:
        if not any(self.cond_mode.startswith(v) for v in VARIANTS):
            raise ValueError(f"unknown variant in cond_mode={self.cond_mode!r} "
                             f"(the MDMPlus denoiser is one of {VARIANTS})")
        validate_parallel(self)
        if self.impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, not {self.dtype}")


class MDMPlus(nn.Module):
    """forward(x, timesteps, cond, uncond=None, train=False, generator=None, cond_drop=None)

    x: (B, njoints, nfeats, T) noisy window; timesteps: (B,) int;
    cond: {'style': (B, style_dim_in), 'seed': (B, njoints, nfeats, n_seed),
           'audio': (B, T_a, source_audio_dim), 'mask_local': (B, T) bool and,
           for cross_local_attention5, 'seed_last': (B, njoints, nfeats, n_seed)} and
           optionally `cond_invariants(cond)`'s entries,
    T_a = T (variant 3), T − n_seed (4), T − 2·n_seed (5);
    uncond: optional (B,) bool, per-example condition drop for CFG;
    train / generator / cond_drop: as `MDM.forward` (the seed drop acts in
    variant 3 only). Returns the x0 prediction, (B, njoints, nfeats, T); a
    train forward with `moe_experts > 0` returns (prediction, mean
    load-balance loss of the MoE layers).
    """

    def __init__(self, cfg: MDMPlusConfig = MDMPlusConfig()):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        D, A = cfg.latent_dim, cfg.audio_feat_dim
        variant = cfg.variant
        self.embed_timestep = TimestepEmbedder(D)
        if variant == "cross_local_attention3":
            self.embed_style = nn.Linear(cfg.style_dim_in, cfg.style_dim)
            self.embed_text = nn.Linear(cfg.input_feats * cfg.n_seed, D - cfg.style_dim)
        else:
            self.embed_style = nn.Linear(cfg.style_dim_in, D)
            self.embed_text = nn.Linear(cfg.input_feats, A)
            if variant == "cross_local_attention5":
                self.embed_text_last = nn.Linear(cfg.input_feats, A)
        self.WavEncoder = WavEncoder(cfg.source_audio_dim, A)
        self.input_process = InputProcess(cfg.input_feats, D)
        self.input_process2 = nn.Linear(2 * D + A, D)
        self.seqTransEncoder = TorchTransformerEncoder(
            cfg.num_layers, D, cfg.num_heads, cfg.ff_size, cfg.activation, cfg.dropout,
            cfg.moe_experts, cfg.moe_capacity_factor, cfg.split_qkv)
        self.output_process = OutputProcess(cfg.input_feats, D, cfg.njoints, cfg.nfeats)

    def cond_invariants(self, cond: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """What `forward` computes from `cond` alone, the same at every
        denoising step, as `MDM.cond_invariants`: the style embedding
        `style_emb` (before `mask_cond`), the per-frame conditioning
        `audio_emb` (variant 3: the features through `WavEncoder`; 4 and 5:
        the projected seed frames, the features and, in 5, the projected
        `seed_last` along time) and, in variant 3, the seed embedding
        `seed_emb`."""
        out = {"style_emb": self.embed_style(cond["style"]), "audio_emb": self._frames(cond)}
        if self.cfg.variant == "cross_local_attention3":
            # from the seed itself, not from an entry an earlier window left in `cond`
            out["seed_emb"] = seed_embedding(self.embed_text, {"seed": cond["seed"]})
        return out

    def _frames(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The per-frame conditioning the local block reads beside the poses."""
        enc_audio = self.WavEncoder(cond["audio"])                        # (B, T_a, A)
        if self.cfg.variant == "cross_local_attention3":
            return enc_audio
        # each seed frame projected and prepended along time; ++ appends seed_last
        parts = [self.embed_text(cond["seed"][:, :, 0].transpose(1, 2)), enc_audio]
        if self.cfg.variant == "cross_local_attention5":
            parts.append(self.embed_text_last(cond["seed_last"][:, :, 0].transpose(1, 2)))
        return torch.cat(parts, dim=1)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, torch.Tensor],
                uncond: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cond_drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        cfg = self.cfg
        B, _, _, T = x.shape
        D, H = cfg.latent_dim, cfg.local_heads
        variant = cfg.variant
        if train and cfg.impl != "plain":
            raise ValueError(
                "train=True needs MDMPlusConfig(impl='plain'): the CUDA kernels have no "
                "backward, as the Pallas kernels of the JAX package have none")

        style_drop = seed_drop = None
        if train and cond_drop is not None:
            style_drop, seed_drop = cond_drop
        elif train and cfg.cond_mask_prob > 0.0:
            # independent draws for style and seed, as the reference's two mask_cond calls
            style_drop, seed_drop = (
                draws.rand((B,), generator, x.device) < cfg.cond_mask_prob for _ in range(2))

        emb_t = self.embed_timestep(timesteps)
        style_emb = mask_cond(style_embedding(self.embed_style, cond), uncond, style_drop)
        enc_text = cond["audio_emb"] if "audio_emb" in cond else self._frames(cond)  # (B, T, A)
        if variant == "cross_local_attention3":
            seed_emb = seed_embedding(self.embed_text, cond, uncond, seed_drop)
            token = torch.cat([style_emb, seed_emb], dim=-1) + emb_t
        else:
            token = style_emb + emb_t
        if enc_text.shape[1] != T:
            raise ValueError(f"{variant}: the conditioning spans {enc_text.shape[1]} frames, "
                             f"the motion {T}")
        x_ = self.input_process(x)                                        # (B, T, D)

        cat = torch.cat([token[:, None, :].expand(B, T, D), x_, enc_text], dim=-1)
        h = local_block(self.input_process2(cat), H, cfg.window_size, cond.get("mask_local"),
                        cfg.impl, seq_group(cfg))
        aux = [] if train and cfg.moe_experts else None
        out = self.output_process(trunk(self.seqTransEncoder, token, h, H, cfg.impl,
                                        cfg.dtype == torch.bfloat16, train, generator, aux,
                                        trunk_pipe(cfg)))
        return out if aux is None else (out, torch.stack(aux).mean())


def beat_mdm(**overrides) -> MDMPlus:
    """BEAT v0 config (reference `end2end.py:81-89`)."""
    base = dict(njoints=2052, latent_dim=384, source_audio_dim=1434, audio_feat_dim=96,
                style_dim_in=2)
    base.update(overrides)
    return MDMPlus(MDMPlusConfig(**base))


def twh_mdm(**overrides) -> MDMPlus:
    """TWH config (reference `end2end.py:90-99`)."""
    base = dict(njoints=2232, latent_dim=512, source_audio_dim=1435, audio_feat_dim=128,
                style_dim_in=17)
    base.update(overrides)
    return MDMPlus(MDMPlusConfig(**base))
