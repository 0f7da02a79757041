"""MDM denoiser, ZEGGS variant (DiffuseStyleGesture), every conditioning mode and trunk.

Port of `diffusestylegesture_tpu/models/mdm.py` and of its serving twin
`models/fused_mdm.py` (reference `main/model/mdm.py:10-358`). The live
configuration is `cond_mode='cross_local_attention3_style1'`,
`audio_feat='wavlm'` (latent 256, 8 layers, 4 encoder heads, 8 local/rotary
heads, window 11). Per step:

  token = [style emb | seed emb] + timestep emb
  h = local_attention(rope(heads(Linear([token | pose emb | audio emb]))))
  out = Linear(encoder_trunk(rope(heads([token ; h])))[1:])

The rest of the JAX `MDMConfig` matrix (`mdm.py:152-300`):

* `cross_local_attention5`: the local block only; plain
  `cross_local_attention`: the trunk first, then the local block;
* the plain branches (a cond mode without `cross_local_attention`, e.g.
  `style1` / `style2`): pose features, (the token, for `gru`,) the audio
  features and (`style2`, not `gru`) a second style embedding are concatenated
  per frame and projected (`input_process_plain`); then `trans_enc` (the token
  prepended, sinusoidal positions added), `mytrans_enc` (the same with RoPE
  over the whole latent as one head instead), `trans_dec` (a post-norm decoder
  over the frames with the token as its one-row memory) or `gru` (additive
  positions, then a `num_layers` GRU). As in the JAX package, these repair
  the reference's unrunnable branches with the same style/seed + timestep
  token;
* `audio_feat`: 'wavlm' (1024 → 64 through `WavEncoder`), 'mfcc' (13-d) or
  'wav encoder' (32-d), the last two precomputed per frame;
* `n_seed = 0` (no seed embedding), and `moe_experts` on every encoder trunk
  (`models/moe.py`; a train forward then returns `(prediction, aux)`, the
  mean of the layers' load-balance losses).

The local attention and each dense encoder layer run through the
hand-written CUDA kernels on a CUDA tensor (`ops/`); ``impl='plain'`` runs
their plain PyTorch versions instead. The parallel slice's fields
(`parallel/`): `split_qkv` (the trunk's in-projection as q / k / v Linears;
kernel B reads their concatenation), `trunk_impl='pipeline'` over
`pipe_mesh` (GPipe; kernel B in each stage) and `remat`, `seq_parallel` over
`seq_mesh` (the local attention's time axis sharded; kernel A on each shard's
[halo | shard]); Megatron tensor parallelism is set on the trunk by the
trainer (`parallel/tp.py::tensor_parallel_trunk`). The MoE FFN, the decoder and the GRU
have no kernel and run their plain ops on every device.

``train=True`` is the training forward: per-example Bernoulli(`cond_mask_prob`)
drops of the style and of the seed on top of `uncond` (JAX `mdm.py:153-160`;
the `style2` embedding takes the style drop), and dropout in the trunk, all
drawn from the `generator` passed in, in that order. It needs
``impl='plain'``, the counterpart of the JAX trainer's XLA path
(`attn_impl="xla"`, the flax trunk): neither CUDA kernel has a backward, nor
has either Pallas kernel.

``dtype=torch.bfloat16`` is the serving mode (`--serve_fast`, with
``activation='gelu_tanh'``): every encoder layer runs kernel B in its
`mxu_bf16` mode (bf16 matmul operands, float32 sums; on the CPU the plain
twin `TorchTransformerEncoder(..., mxu_bf16=True)`), and the MoE FFN and the
decoder round their matmul operands the same way; the GRU stays float32. The
rest stays float32, the local block included: kernel A takes float32 only.
The JAX model with ``dtype=bfloat16`` (and bf16-cast params) runs the local
block and the trunk's activations in bf16 as well; the port is held to it by
the bench gate's bar, RMS/std 2e-2 of the final poses. Parameter names are
the reference module's, so a reference state_dict loads with
`load_state_dict` once `clip_model.*` and the unused buffers are dropped
(`models/convert.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel import draws
from . import rotary
from .embeddings import (InputProcess, OutputProcess, TimestepEmbedder, WavEncoder, mask_cond,
                         sinusoidal_pe)
from .local_attention import local_attention
from .transformer import Pipe, TorchTransformerDecoder, TorchTransformerEncoder

AUDIO_FEAT_DIMS = {"wav encoder": 32, "mfcc": 13, "wavlm": 64}
ARCHS = ("trans_enc", "mytrans_enc", "trans_dec", "gru")


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
    audio_feat: str = "wavlm"  # "wavlm" | "mfcc" | "wav encoder"
    audio_in_dim: int = 1024  # WavLM feature width (Large: 1024)
    style_dim_in: int = 6
    style_dim: int = 64
    n_seed: int = 8
    cond_mode: str = "cross_local_attention3_style1"
    cond_mask_prob: float = 0.1
    window_size: int = 11
    # the trunk of the plain (non cross_local_attention) branches
    arch: str = "trans_enc"
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    # "loop" | "pipeline": the trunk's layers GPipe-pipelined over the
    # `pipe_axis` group of `pipe_mesh` (a DeviceMesh), `pipe_microbatches`
    # microbatches (0: the axis size); `remat` recomputes the trunk in the
    # backward (`parallel/pipeline.py`)
    trunk_impl: str = "loop"
    pipe_mesh: object = None
    pipe_axis: str = "pipe"
    pipe_microbatches: int = 0
    remat: bool = False
    # the trunk's in-projection as q / k / v Linears (`parallel/tp.py`)
    split_qkv: bool = False
    # the local attention's time axis sharded over the `seq_axis` group of
    # `seq_mesh` (JAX attn_impl="seq_parallel", `parallel/seq_parallel.py`)
    seq_parallel: bool = False
    seq_mesh: object = None
    seq_axis: str = "seq"
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

    @property
    def ordering(self) -> str:
        """'local_trunk' (cross_local_attention3), 'local' (5), 'trunk_local'
        (cross_local_attention) or 'plain'."""
        for key, order in (("cross_local_attention3", "local_trunk"),
                           ("cross_local_attention5", "local"),
                           ("cross_local_attention", "trunk_local")):
            if key in self.cond_mode:
                return order
        return "plain"

    def validate(self) -> None:
        validate_parallel(self)
        if self.audio_feat not in AUDIO_FEAT_DIMS:
            raise ValueError(f"unknown audio_feat {self.audio_feat!r} ({sorted(AUDIO_FEAT_DIMS)})")
        if self.ordering == "plain":
            if self.arch not in ARCHS:
                raise ValueError(f"unknown arch {self.arch!r} ({ARCHS})")
            if self.arch in ("trans_dec", "gru") and (
                    self.split_qkv or self.moe_experts or self.trunk_impl != "loop"):
                # these arches have no encoder trunk (JAX mdm.py:252-259)
                raise ValueError(f"arch={self.arch!r} supports neither split_qkv, "
                                 "moe_experts nor a pipelined trunk")
        if "style1" in self.cond_mode and self.n_seed == 0 and self.style_dim != self.latent_dim:
            raise ValueError("style1 with n_seed=0 makes the style embedding the token: "
                             "style_dim must equal latent_dim")
        if self.impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, not {self.dtype}")


class MDM(nn.Module):
    """forward(x, timesteps, cond, uncond=None, train=False, generator=None, cond_drop=None)

    x: (B, njoints, nfeats, T) noisy window; timesteps: (B,) int;
    cond: {'style': (B, 6), 'seed': (B, njoints, nfeats, n_seed),
           'audio': (B, T, 1024 wavlm | 13 mfcc | 32 wav encoder),
           'mask_local': (B, T) bool};
    uncond: optional (B,) bool, per-example condition drop for CFG;
    train: the training forward (module docstring), which draws from
    `generator`; cond_drop: optional ((B,) style drops, (B,) seed drops) used
    in place of the draws, so that a test can replay another trainer's.
    Returns the x0 prediction, (B, njoints, nfeats, T); a train forward with
    `moe_experts > 0` returns (prediction, mean load-balance loss).
    """

    def __init__(self, cfg: MDMConfig = MDMConfig()):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        D, A = cfg.latent_dim, cfg.audio_feat_dim
        order = cfg.ordering
        self.embed_timestep = TimestepEmbedder(D)
        style2 = order == "plain" and "style2" in cfg.cond_mode and cfg.arch != "gru"
        if "style1" in cfg.cond_mode:
            self.embed_style = nn.Linear(cfg.style_dim_in, cfg.style_dim)
            if cfg.n_seed:
                self.embed_text = nn.Linear(cfg.input_feats * cfg.n_seed, D - cfg.style_dim)
        elif cfg.n_seed:
            self.embed_text = nn.Linear(cfg.input_feats * cfg.n_seed, D)
        if style2:
            self.embed_style = nn.Linear(cfg.style_dim_in, cfg.style_dim)
        if cfg.audio_feat == "wavlm":
            self.WavEncoder = WavEncoder(cfg.audio_in_dim, A)
        # the JAX MDM applies input_process in every branch, so every checkpoint
        # holds it; the plain branches do not read it
        self.input_process = InputProcess(cfg.input_feats, D)
        if order == "plain":
            width = cfg.input_feats + A + (D if cfg.arch == "gru" else 0) + (
                cfg.style_dim if style2 else 0)
            self.input_process_plain = nn.Linear(width, D)
            self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(5000, D)), persistent=False)
        else:
            self.input_process2 = nn.Linear(2 * D + A, D)
        if order in ("local_trunk", "trunk_local") or cfg.arch in ("trans_enc", "mytrans_enc") \
                and order == "plain":
            self.seqTransEncoder = TorchTransformerEncoder(
                cfg.num_layers, D, cfg.num_heads, cfg.ff_size, cfg.activation, cfg.dropout,
                cfg.moe_experts, cfg.moe_capacity_factor, cfg.split_qkv)
        elif order == "plain" and cfg.arch == "trans_dec":
            self.seqTransDecoder = TorchTransformerDecoder(
                cfg.num_layers, D, cfg.num_heads, cfg.ff_size, cfg.activation, cfg.dropout)
        elif order == "plain":
            self.gru = nn.GRU(D, D, cfg.num_layers, batch_first=True)
        self.output_process = OutputProcess(cfg.input_feats, D, cfg.njoints, cfg.nfeats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, torch.Tensor],
                uncond: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cond_drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
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
                draws.rand((B,), generator, x.device) < cfg.cond_mask_prob for _ in range(2))

        emb_t = self.embed_timestep(timesteps)
        seed = None
        if cfg.n_seed:
            seed = self.embed_text(mask_cond(cond["seed"].reshape(B, -1), uncond, seed_drop))
        if "style1" in cfg.cond_mode:
            style_emb = mask_cond(self.embed_style(cond["style"]), uncond, style_drop)
            token = style_emb if seed is None else torch.cat([style_emb, seed], dim=-1)
        else:
            token = seed if seed is not None else torch.zeros(B, D, device=x.device)
        token = token + emb_t                                             # (B, D)
        enc_audio = self.WavEncoder(cond["audio"]) if cfg.audio_feat == "wavlm" else cond["audio"]
        mxu_bf16 = cfg.dtype == torch.bfloat16
        aux = [] if train and cfg.moe_experts else None
        order = cfg.ordering

        def local(seq):
            # cat(token, seq, audio) → Linear → RoPE → windowed attention
            cat = torch.cat([token[:, None, :].expand(B, T, D), seq, enc_audio], dim=-1)
            return local_block(self.input_process2(cat), H, cfg.window_size,
                               cond.get("mask_local"), cfg.impl, seq_group(cfg))

        def encoder(seq):
            return trunk(self.seqTransEncoder, token, seq, H, cfg.impl, mxu_bf16, train,
                         generator, aux, trunk_pipe(cfg))

        if order == "local_trunk":
            out = encoder(local(self.input_process(x)))
        elif order == "local":
            out = local(self.input_process(x))
        elif order == "trunk_local":
            out = local(encoder(self.input_process(x)))
        else:
            out = self._plain(x, token, enc_audio, cond, uncond, style_drop, mxu_bf16, train,
                              generator, aux)
        out = self.output_process(out)
        if aux is not None:
            return out, torch.stack(aux).mean()
        return out

    def _plain(self, x, token, enc_audio, cond, uncond, style_drop, mxu_bf16, train, generator,
               aux):
        """The plain branches (JAX `mdm.py:229-297`): per-frame features →
        `input_process_plain` → additive sinusoidal positions (RoPE over the
        whole latent for mytrans_enc) → the arch's trunk."""
        cfg = self.cfg
        B, _, _, T = x.shape
        D = cfg.latent_dim
        feats = [x.reshape(B, cfg.input_feats, T).transpose(1, 2), enc_audio]
        if cfg.arch == "gru":
            feats.insert(1, token[:, None, :].expand(B, T, D))
        elif "style2" in cfg.cond_mode:
            style2 = mask_cond(self.embed_style(cond["style"]), uncond, style_drop)
            feats.append(style2[:, None, :].expand(B, T, cfg.style_dim))
        h = self.input_process_plain(torch.cat(feats, dim=-1))
        if cfg.arch in ("trans_enc", "mytrans_enc"):
            seq = torch.cat([token[:, None, :], h], dim=1)
            seq = rotary.rope(seq) if cfg.arch == "mytrans_enc" else seq + self.pe[: T + 1]
            return self.seqTransEncoder(seq, impl=cfg.impl, mxu_bf16=mxu_bf16, train=train,
                                        generator=generator, aux=aux,
                                        pipe=trunk_pipe(cfg))[:, 1:]
        seq = h + self.pe[:T]
        if cfg.arch == "trans_dec":
            return self.seqTransDecoder(seq, token[:, None, :], mxu_bf16, train, generator)
        return self.gru(seq)[0]


def validate_parallel(cfg) -> None:
    """The parallel fields every denoiser config shares (MDM, MDMPlus, and
    TextMDM's trunk ones)."""
    if cfg.trunk_impl not in ("loop", "pipeline"):
        raise ValueError(f"unknown trunk_impl {cfg.trunk_impl!r} (loop or pipeline)")
    if cfg.trunk_impl == "pipeline":
        if cfg.pipe_mesh is None:
            raise ValueError("trunk_impl='pipeline' needs pipe_mesh (a DeviceMesh with a "
                             f"{cfg.pipe_axis!r} axis)")
    if (cfg.trunk_impl == "pipeline" or cfg.remat) and cfg.moe_experts:
        # the JAX CLI refuses MoE with --pp too: the pipelined (or recomputed)
        # trunk does not carry the MoE layers' load-balance loss
        raise ValueError("moe_experts with a pipelined or remat trunk is unsupported")
    if getattr(cfg, "seq_parallel", False) and cfg.seq_mesh is None:
        raise ValueError(f"seq_parallel needs seq_mesh (a DeviceMesh with a {cfg.seq_axis!r} "
                         "axis)")


def seq_group(cfg):
    """The `seq` process group of a sequence-parallel config, else None."""
    return cfg.seq_mesh.get_group(cfg.seq_axis) if getattr(cfg, "seq_parallel", False) else None


def trunk_pipe(cfg) -> Optional[Pipe]:
    """How the config's trunk runs pipelined (`Pipe`), or None for the plain loop."""
    if cfg.trunk_impl == "pipeline":
        mesh = cfg.pipe_mesh
        names = mesh.mesh_dim_names
        data = mesh.size(names.index("data")) if "data" in names else 1
        return Pipe(mesh.get_group(cfg.pipe_axis), cfg.pipe_microbatches, cfg.remat, data)
    return Pipe(None, 1, True) if cfg.remat else None


def local_block(proj: torch.Tensor, heads: int, window: int, mask: Optional[torch.Tensor],
                impl: str, seq=None) -> torch.Tensor:
    """(B, T, D) projected tokens → RoPE over `heads` heads → windowed causal
    local attention → (B, T, D). On the kernel route RoPE runs in the
    (B, T, H, hd) layout the Linear wrote, and kernel A reads the heads through
    strides and writes the merged (B, T, D) layout. `seq`: a `seq` process
    group, over which the attention's time axis is sharded
    (`parallel/seq_parallel.py`; kernel A per shard on the kernel route)."""
    B, T, D = proj.shape
    if seq is not None:
        from ..parallel.seq_parallel import sequence_parallel_local_attention

        hh = rotary.rope(rotary.heads_split(proj, heads)).contiguous()
        if mask is None:
            mask = torch.ones(B, T, dtype=torch.bool, device=proj.device)
        hh = sequence_parallel_local_attention(hh, hh, hh, window, seq, mask.bool(),
                                               heads=heads, impl=impl)
        return rotary.heads_merge(hh, B, heads)
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
          generator=None, aux: Optional[list] = None,
          pipe: Optional[Pipe] = None) -> torch.Tensor:
    """Prepend the (B, D) token to the (B, T, D) frames, RoPE over `heads`
    heads, run the encoder layers (kernel B on the kernel route for the dense
    ones; pipelined with `pipe`), drop the token: (B, T, D). MoE layers append
    their load-balance loss to `aux`."""
    B = h.shape[0]
    seq = torch.cat([token[:, None, :], h], dim=1)
    seq = rotary.heads_merge(rotary.rope(rotary.heads_split(seq, heads)), B, heads).contiguous()
    return encoder(seq, impl=impl, mxu_bf16=mxu_bf16, train=train, generator=generator,
                   aux=aux, pipe=pipe)[:, 1:]
