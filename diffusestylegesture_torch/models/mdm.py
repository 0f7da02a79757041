"""MDM denoiser, ZEGGS variant (DiffuseStyleGesture), inference.

Port of `diffusestylegesture_tpu/models/mdm.py` and of its serving twin
`models/fused_mdm.py` for the live configuration
`cond_mode='cross_local_attention3_style1'`, `audio_feat='wavlm'` (latent
256, 8 layers, 4 encoder heads, 8 local/rotary heads, window 11; reference
`main/model/mdm.py:10-358`). Per step:

  token = [style emb | seed emb] + timestep emb
  h = local_attention(rope(heads(Linear([token | pose emb | audio emb]))))
  out = Linear(encoder_trunk(rope(heads([token ; h])))[1:])

The local attention and each trunk layer run through the hand-written
CUDA kernels on a CUDA tensor (`ops/`); ``impl='plain'`` runs their plain
PyTorch versions instead.

``dtype=torch.bfloat16`` is the serving mode (`--serve_fast`, with
``activation='gelu_tanh'``): every trunk layer runs kernel B in its
`mxu_bf16` mode (bf16 matmul operands, float32 sums; on the CPU the plain
twin `TorchTransformerEncoder(..., mxu_bf16=True)`). The rest stays float32,
the local block included: kernel A takes float32 only. The JAX model with
``dtype=bfloat16`` (and bf16-cast params) runs the local block and the trunk's
activations in bf16 as well; the port is held to it by the bench gate's
bar, RMS/std 2e-2 of the final poses. Parameter names are the reference module's, so
a reference state_dict loads with `load_state_dict` once `clip_model.*`
and the unused buffers are dropped (`models/convert.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from . import rotary
from .embeddings import InputProcess, OutputProcess, TimestepEmbedder, WavEncoder, mask_cond
from .local_attention import local_attention
from .transformer import TorchTransformerEncoder

AUDIO_FEAT_DIMS = {"wavlm": 64}


@dataclasses.dataclass(frozen=True)
class MDMConfig:
    njoints: int = 1141
    nfeats: int = 1
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4  # transformer-encoder heads
    local_heads: int = 8  # rotary / local-attention heads
    activation: str = "gelu"
    audio_feat: str = "wavlm"
    audio_in_dim: int = 1024  # WavLM feature width (Large: 1024)
    style_dim_in: int = 6
    style_dim: int = 64
    n_seed: int = 8
    cond_mode: str = "cross_local_attention3_style1"
    cond_mask_prob: float = 0.1
    window_size: int = 11
    arch: str = "trans_enc"
    trunk_impl: str = "loop"
    split_qkv: bool = False
    moe_experts: int = 0
    # "kernel": the CUDA kernels on CUDA tensors; "plain": the plain
    # PyTorch versions everywhere (the comparison path)
    impl: str = "kernel"
    # torch.float32, or torch.bfloat16: the trunk's matmul operands in bf16
    dtype: torch.dtype = torch.float32

    @property
    def audio_feat_dim(self) -> int:
        return AUDIO_FEAT_DIMS[self.audio_feat]

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    def validate(self) -> None:
        unsupported = []
        if self.cond_mode != "cross_local_attention3_style1":
            unsupported.append(f"cond_mode={self.cond_mode!r}")
        if self.audio_feat != "wavlm":
            unsupported.append(f"audio_feat={self.audio_feat!r}")
        if self.arch != "trans_enc":
            unsupported.append(f"arch={self.arch!r}")
        if self.trunk_impl != "loop":
            unsupported.append(f"trunk_impl={self.trunk_impl!r}")
        if self.split_qkv:
            unsupported.append("split_qkv")
        if self.moe_experts:
            unsupported.append(f"moe_experts={self.moe_experts}")
        if self.n_seed == 0:
            unsupported.append("n_seed=0")
        if unsupported:
            raise NotImplementedError(
                "the PyTorch port implements only the ZEGGS cross_local_attention3_style1 "
                "+ wavlm denoiser; unsupported: " + ", ".join(unsupported))
        if self.impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, not {self.dtype}")


class MDM(nn.Module):
    """forward(x, timesteps, cond, uncond=None)

    x: (B, njoints, nfeats, T) noisy window; timesteps: (B,) int;
    cond: {'style': (B, 6), 'seed': (B, njoints, nfeats, n_seed),
           'audio': (B, T, 1024), 'mask_local': (B, T) bool};
    uncond: optional (B,) bool, per-example condition drop for CFG.
    Returns the x0 prediction, (B, njoints, nfeats, T).
    """

    def __init__(self, cfg: MDMConfig = MDMConfig()):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        D = cfg.latent_dim
        self.embed_timestep = TimestepEmbedder(D)
        self.embed_style = nn.Linear(cfg.style_dim_in, cfg.style_dim)
        self.embed_text = nn.Linear(cfg.input_feats * cfg.n_seed, D - cfg.style_dim)
        self.WavEncoder = WavEncoder(cfg.audio_in_dim, cfg.audio_feat_dim)
        self.input_process = InputProcess(cfg.input_feats, D)
        self.input_process2 = nn.Linear(2 * D + cfg.audio_feat_dim, D)
        self.seqTransEncoder = TorchTransformerEncoder(
            cfg.num_layers, D, cfg.num_heads, cfg.ff_size, cfg.activation)
        self.output_process = OutputProcess(cfg.input_feats, D, cfg.njoints, cfg.nfeats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, torch.Tensor],
                uncond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, _, _, T = x.shape
        D, H = cfg.latent_dim, cfg.local_heads

        emb_t = self.embed_timestep(timesteps)
        style_emb = mask_cond(self.embed_style(cond["style"]), uncond)
        seed_emb = self.embed_text(mask_cond(cond["seed"].reshape(B, -1), uncond))
        token = torch.cat([style_emb, seed_emb], dim=-1) + emb_t        # (B, D)
        enc_audio = self.WavEncoder(cond["audio"])                        # (B, T, 64)
        x_ = self.input_process(x)                                        # (B, T, D)

        # local block: cat(token, pose, audio) → Linear → RoPE → windowed attention
        cat = torch.cat([token[:, None, :].expand(B, T, D), x_, enc_audio], dim=-1)
        if cfg.impl == "kernel":
            # RoPE in the (B, T, H, hd) layout the Linear wrote; the kernel reads
            # the heads through strides and writes the merged (B, T, D) layout
            hh = rotary.rope_heads(self.input_process2(cat), H).transpose(1, 2)
            h = torch.empty(B, T, D, dtype=hh.dtype, device=hh.device)
            local_attention(hh, hh, hh, cfg.window_size, cond.get("mask_local"), heads=H,
                            out=h.view(B, T, H, D // H).transpose(1, 2))
        else:
            hh = rotary.rope(rotary.heads_split(self.input_process2(cat), H)).contiguous()
            hh = local_attention(hh, hh, hh, cfg.window_size, cond.get("mask_local"), heads=H,
                                 impl="plain")
            h = rotary.heads_merge(hh, B, H)

        # trunk: prepend token → RoPE over heads → encoder layers → drop token
        seq = torch.cat([token[:, None, :], h], dim=1)
        seq = rotary.heads_merge(rotary.rope(rotary.heads_split(seq, H)), B, H).contiguous()
        out = self.seqTransEncoder(seq, impl=cfg.impl,
                                   mxu_bf16=cfg.dtype == torch.bfloat16)[:, 1:]
        return self.output_process(out)
