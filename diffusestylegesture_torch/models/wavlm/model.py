"""WavLM speech encoder (Microsoft WavLM, Base and Large layouts), inference.

Port of `diffusestylegesture_tpu/models/wavlm/model.py` (reference
`main/mydiffusion_zeggs/WavLM/WavLM.py` + `modules_WavLM.py`):

  * 7-layer conv feature extractor, strides (5,2,2,2,2,2,2); "default"
    mode = GroupNorm(512, 512) after the first conv, "layer_norm" mode =
    LayerNorm after every conv (Large); exact GELU.
  * feature LayerNorm + optional 512 → D projection.
  * convolutional positional embedding (kernel 128, groups 16, pad 64),
    SamePad trim of the last frame for an even kernel, GELU. The
    weight-norm of the checkpoint is folded into a plain weight on load.
  * transformer with the T5-style bucketed relative position bias computed
    at layer 0 and shared by every layer, each layer gating it GRU-style
    from its own queries, pre-LN (Large) or post-LN (Base) blocks.

Plain PyTorch ops (the JAX package leaves this encoder to XLA; it has no
Pallas kernel). ``WavLMConfig.dtype=torch.bfloat16`` (`--serve_fast`) holds
the weights and runs the convolutions and matmuls in bf16, with LayerNorm /
GroupNorm statistics and the attention softmax in float32, as the JAX
config's `dtype` does (`models/wavlm/model.py:44-54`, `:282-288`); the
features come out in bf16. Module names follow the reference, so a reference
state_dict loads once the pos-conv weight-norm is folded
(`models/convert.py::load_wavlm_checkpoint`).
"""
from __future__ import annotations

import ast
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    extractor_mode: str = "layer_norm"  # Large; "default" for Base
    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_embed_dim: int = 4096
    encoder_attention_heads: int = 16
    activation_fn: str = "gelu"
    layer_norm_first: bool = True  # Large; False for Base
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2),
    )
    conv_bias: bool = False
    normalize: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype: float32 or bfloat16

    @classmethod
    def from_torch_cfg(cls, cfg: dict) -> "WavLMConfig":
        """Build from a checkpoint's stored cfg dict (`WavLM.py:213-217`)."""
        layers = cfg.get("conv_feature_layers",
                         "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2")
        if isinstance(layers, str):
            layers = _parse_conv_layers(layers)
        layers = tuple(tuple(int(v) for v in t) for t in layers)
        keep = {f.name for f in dataclasses.fields(cls)} - {"conv_feature_layers", "dtype"}
        return cls(conv_feature_layers=layers, **{k: v for k, v in cfg.items() if k in keep})


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to x's dtype (a no-op cast
    in float32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def _parse_conv_layers(spec: str):
    """Evaluate a fairseq conv-layer spec such as
    ``"[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"`` allowing only
    list/tuple/int literals with ``+`` and ``*`` — never arbitrary code."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.BinOp):
            left, right = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Mult):
                return left * right
            raise ValueError(f"unsupported operator in conv spec: {ast.dump(node.op)}")
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = [ev(e) for e in node.elts]
            return elts if isinstance(node, ast.List) else tuple(elts)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        raise ValueError(f"unsupported node in conv spec: {ast.dump(node)}")

    return ev(ast.parse(spec, mode="eval"))


class ConvFeatureExtractor(nn.Module):
    """(B, S) waveform → (B, T, C) features. `conv_layers.{i}` mirrors the
    reference's Sequential(conv, dropout, norm, GELU) indices."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.mode = cfg.extractor_mode
        if self.mode not in ("default", "layer_norm"):
            raise ValueError(f"unknown extractor_mode {self.mode!r}")
        layers = []
        in_d = 1
        for i, (dim, k, stride) in enumerate(cfg.conv_feature_layers):
            conv = nn.Conv1d(in_d, dim, k, stride=stride, bias=cfg.conv_bias)
            if self.mode == "layer_norm":
                norm = nn.Sequential(nn.Identity(), nn.LayerNorm(dim, eps=1e-5), nn.Identity())
                layers.append(nn.Sequential(conv, nn.Identity(), norm, nn.GELU()))
            elif i == 0:
                layers.append(nn.Sequential(conv, nn.Identity(), nn.GroupNorm(dim, dim, eps=1e-5),
                                            nn.GELU()))
            else:
                layers.append(nn.Sequential(conv, nn.Identity(), nn.GELU()))
            in_d = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]  # (B, 1, S)
        for i, layer in enumerate(self.conv_layers):
            h = layer[0](h)
            if self.mode == "layer_norm":
                h = _ln(layer[2][1], h.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                gn = layer[2]
                h = F.group_norm(h.float(), gn.num_groups, gn.weight.float(), gn.bias.float(),
                                 gn.eps).to(h.dtype)
            h = F.gelu(h)
        return h.transpose(1, 2)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5 bidirectional bucketing (`modules_WavLM.py:417-442`)."""
    num_buckets = num_buckets // 2
    rel_buckets = (relative_position > 0).long() * num_buckets
    rp = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    rp_large = max_exact + (
        torch.log(rp.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).long()
    rp_large = torch.clamp(rp_large, max=num_buckets - 1)
    return rel_buckets + torch.where(is_small, rp, rp_large)


class GatedRelPosAttention(nn.Module):
    """Self-attention with the shared relative-position bias and a per-layer GRU gate."""

    def __init__(self, cfg: WavLMConfig, has_relative_attention_bias: bool):
        super().__init__()
        D, H = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        self.cfg, self.D, self.H = cfg, D, H
        self.has_relative_attention_bias = has_relative_attention_bias
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(cfg.num_buckets, H)
        if cfg.gru_rel_pos:
            self.grep_linear = nn.Linear(D // H, 8)
            self.grep_a = nn.Parameter(torch.ones(1, H, 1, 1))

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor],
                padding_mask: Optional[torch.Tensor] = None):
        cfg, D, H = self.cfg, self.D, self.H
        hd = D // H
        B, T, _ = x.shape
        if self.has_relative_attention_bias and position_bias is None:
            pos = torch.arange(T, device=x.device)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.num_buckets,
                                               cfg.max_distance)
            position_bias = self.relative_attention_bias(buckets).permute(2, 0, 1)  # (H, T, T)

        qh = self.q_proj(x).reshape(B, T, H, hd).transpose(1, 2)
        kh = self.k_proj(x).reshape(B, T, H, hd).transpose(1, 2)
        vh = self.v_proj(x).reshape(B, T, H, hd).transpose(1, 2)

        sim = torch.matmul(qh * hd ** -0.5, kh.transpose(-1, -2)).float()
        if position_bias is not None:
            bias = position_bias[None]
            if cfg.gru_rel_pos:
                # gate from the raw (unscaled) queries, `modules_WavLM.py:523-533`
                gates = torch.sigmoid(self.grep_linear(qh).reshape(B, H, T, 2, 4).sum(-1))
                gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
                bias = (gate_a * (gate_b * self.grep_a - 1.0) + 2.0) * bias
            sim = sim + bias
        if padding_mask is not None:
            sim = sim.masked_fill(padding_mask[:, None, None, :], torch.finfo(torch.float32).min)
        out = torch.matmul(torch.softmax(sim, dim=-1).to(vh.dtype), vh)
        out = out.transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out), position_bias


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_relative_attention_bias: bool):
        super().__init__()
        self.layer_norm_first = cfg.layer_norm_first
        D = cfg.encoder_embed_dim
        self.self_attn = GatedRelPosAttention(cfg, has_relative_attention_bias)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=1e-5)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_embed_dim, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=1e-5)

    def forward(self, x, position_bias, padding_mask=None):
        if self.layer_norm_first:
            h, position_bias = self.self_attn(_ln(self.self_attn_layer_norm, x), position_bias,
                                              padding_mask)
            x = x + h
            x = x + self.fc2(F.gelu(self.fc1(_ln(self.final_layer_norm, x))))
        else:
            h, position_bias = self.self_attn(x, position_bias, padding_mask)
            x = _ln(self.self_attn_layer_norm, x + h)
            x = _ln(self.final_layer_norm, x + self.fc2(F.gelu(self.fc1(x))))
        return x, position_bias


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        D = cfg.encoder_embed_dim
        # `pos_conv.0` is the (weight-norm-folded) conv of the reference's
        # Sequential(weight_norm(conv), SamePad, GELU)
        self.pos_conv = nn.Sequential(nn.Conv1d(D, D, cfg.conv_pos, padding=cfg.conv_pos // 2,
                                                groups=cfg.conv_pos_groups))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, has_relative_attention_bias=(cfg.relative_position_embedding
                                                           and i == 0))
            for i in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=1e-5)


class WavLM(nn.Module):
    """`extract_features` (`WavLM.py:323-375`), deterministic. (B, S) → (B, T, D)."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.cfg = cfg
        conv_dim = cfg.conv_feature_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.layer_norm = nn.LayerNorm(conv_dim, eps=1e-5)
        self.post_extract_proj = (nn.Linear(conv_dim, cfg.encoder_embed_dim)
                                  if conv_dim != cfg.encoder_embed_dim else None)
        self.encoder = TransformerEncoder(cfg)
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, not {cfg.dtype}")
        self.to(cfg.dtype)

    def forward(self, source: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                output_layer: Optional[int] = None) -> torch.Tensor:
        # NB input wav normalisation (cfg.normalize) is the adapter's job;
        # the ZEGGS adapter skips it (reference quirk)
        cfg = self.cfg
        feats = _ln(self.layer_norm, self.feature_extractor(source.to(cfg.dtype)))
        if self.post_extract_proj is not None:
            feats = self.post_extract_proj(feats)

        pos = self.encoder.pos_conv[0](feats.transpose(1, 2)).transpose(1, 2)
        if cfg.conv_pos % 2 == 0:
            pos = pos[:, :-1]  # SamePad trim (`modules_WavLM.py:72-84`)
        x = feats + F.gelu(pos)

        if not cfg.layer_norm_first:
            x = _ln(self.encoder.layer_norm, x)
        position_bias = None
        n_layers = cfg.encoder_layers if output_layer is None else output_layer
        for layer in self.encoder.layers[:n_layers]:
            x, position_bias = layer(x, position_bias, padding_mask)
        if cfg.layer_norm_first and output_layer is None:
            x = _ln(self.encoder.layer_norm, x)
        return x


def interpolate_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """torch F.interpolate(mode='linear', align_corners=True) over axis 1,
    written out as in the JAX package: (B, T, C) → (B, size, C)."""
    B, T, C = x.shape
    if T == 1:
        return x.expand(B, size, C)
    # source position i·(T−1)/(size−1) in float32: F.interpolate's
    # align_corners formula, and what XLA makes of the JAX linspace
    pos = torch.arange(size, device=x.device, dtype=torch.float32) * ((T - 1) / (size - 1))
    lo = torch.clamp(torch.floor(pos).long(), 0, T - 2)
    w = (pos - lo.float())[None, :, None].to(x.dtype)
    return x[:, lo] * (1 - w) + x[:, lo + 1] * w
