"""MDM denoiser, ZEGGS variant (DiffuseStyleGesture).

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

``train=True`` is the training forward: independent per-example
Bernoulli(`cond_mask_prob`) drops of the style and of the seed on top of
`uncond` (JAX `mdm.py:153-160`), and dropout at the trunk's four places, all
drawn from the `generator` passed in, in that order. It needs
``impl='plain'``, the counterpart of the JAX trainer's XLA path
(`attn_impl="xla"`, the flax trunk): neither CUDA kernel has a backward, nor
has either Pallas kernel.

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
from typing import Dict, Optional, Tuple

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
    dropout: float = 0.1  # the trunk's, in train mode
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
    """forward(x, timesteps, cond, uncond=None, train=False, generator=None, cond_drop=None)

    x: (B, njoints, nfeats, T) noisy window; timesteps: (B,) int;
    cond: {'style': (B, 6), 'seed': (B, njoints, nfeats, n_seed),
           'audio': (B, T, 1024), 'mask_local': (B, T) bool};
    uncond: optional (B,) bool, per-example condition drop for CFG;
    train: the training forward (module docstring), which draws from
    `generator`; cond_drop: optional ((B,) style drops, (B,) seed drops) used
    in place of the draws, so that a test can replay another trainer's.
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
            cfg.num_layers, D, cfg.num_heads, cfg.ff_size, cfg.activation, cfg.dropout)
        self.output_process = OutputProcess(cfg.input_feats, D, cfg.njoints, cfg.nfeats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, torch.Tensor],
                uncond: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cond_drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        cfg = self.cfg
        B, _, _, T = x.shape
        D, H = cfg.latent_dim, cfg.local_heads
        if train and cfg.impl != "plain":
            raise ValueError(
                "train=True needs MDMConfig(impl='plain'): the CUDA kernels have no backward, "
                "as the Pallas kernels of the JAX package have none; training runs the plain "
                "PyTorch ops, the counterpart of the JAX trainer's XLA path")

        style_drop = seed_drop = None
        if train and cond_drop is not None:
            style_drop, seed_drop = cond_drop
        elif train and cfg.cond_mask_prob > 0.0:
            # independent draws for style and seed, as the reference's two mask_cond calls
            style_drop, seed_drop = (
                torch.rand(B, generator=generator, device=x.device) < cfg.cond_mask_prob
                for _ in range(2))

        emb_t = self.embed_timestep(timesteps)
        style_emb = mask_cond(self.embed_style(cond["style"]), uncond, style_drop)
        seed_emb = self.embed_text(mask_cond(cond["seed"].reshape(B, -1), uncond, seed_drop))
        token = torch.cat([style_emb, seed_emb], dim=-1) + emb_t        # (B, D)
        enc_audio = self.WavEncoder(cond["audio"])                        # (B, T, 64)
        x_ = self.input_process(x)                                        # (B, T, D)

        # local block: cat(token, pose, audio) → Linear → RoPE → windowed attention
        cat = torch.cat([token[:, None, :].expand(B, T, D), x_, enc_audio], dim=-1)
        h = local_block(self.input_process2(cat), H, cfg.window_size, cond.get("mask_local"),
                        cfg.impl)
        out = trunk(self.seqTransEncoder, token, h, H, cfg.impl, cfg.dtype == torch.bfloat16,
                    train, generator)
        return self.output_process(out)


def local_block(proj: torch.Tensor, heads: int, window: int, mask: Optional[torch.Tensor],
                impl: str) -> torch.Tensor:
    """(B, T, D) projected tokens → RoPE over `heads` heads → windowed causal
    local attention → (B, T, D). On the kernel route RoPE runs in the
    (B, T, H, hd) layout the Linear wrote, and kernel A reads the heads through
    strides and writes the merged (B, T, D) layout."""
    B, T, D = proj.shape
    if impl == "kernel":
        hh = rotary.rope_heads(proj, heads).transpose(1, 2)
        h = torch.empty(B, T, D, dtype=hh.dtype, device=hh.device)
        local_attention(hh, hh, hh, window, mask, heads=heads,
                        out=h.view(B, T, heads, D // heads).transpose(1, 2))
        return h
    hh = rotary.rope(rotary.heads_split(proj, heads)).contiguous()
    hh = local_attention(hh, hh, hh, window, mask, heads=heads, impl="plain")
    return rotary.heads_merge(hh, B, heads)


def trunk(encoder: TorchTransformerEncoder, token: torch.Tensor, h: torch.Tensor, heads: int,
          impl: str, mxu_bf16: bool, train: bool = False,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prepend the (B, D) token to the (B, T, D) frames, RoPE over `heads`
    heads, run the encoder layers (kernel B on the kernel route), drop the
    token: (B, T, D)."""
    B = h.shape[0]
    seq = torch.cat([token[:, None, :], h], dim=1)
    seq = rotary.heads_merge(rotary.rope(rotary.heads_split(seq, heads)), B, heads).contiguous()
    return encoder(seq, impl=impl, mxu_bf16=mxu_bf16, train=train, generator=generator)[:, 1:]
