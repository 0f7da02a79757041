"""WavLM `extract_features` (Chen et al. 2022; microsoft/unilm `WavLM.py`,
`modules.py`), inference, as plain float32 PyTorch over a dict of weights.

Large layout: a 7-layer convolutional feature extractor with a LayerNorm over
the channels after every convolution and exact GELU; a feature LayerNorm and
the 512 → D projection; the grouped convolutional position embedding (its
last frame trimmed for the even kernel) added through a GELU; pre-LN
transformer layers whose attention adds a T5-style bucketed relative position
bias, made by layer 0 and shared, each layer gating it from its own
projected queries (`grep_linear`, `grep_a`); a final LayerNorm. The sample
rate's layer norm of the wav is not applied (the ZEGGS reference's quirk).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Precision, Weights, layer_norm, linear


def _buckets(T: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = torch.clamp(large, max=half - 1)
    return out + torch.where(n < exact, n, large)


def forward(w: Weights, cfg: dict, wav: torch.Tensor, p: Precision) -> torch.Tensor:
    """(N, S) raw 16 kHz windows → (N, T', D) features of the last layer."""
    h = wav[:, None, :]
    for i, (dim, k, stride) in enumerate(cfg["conv_feature_layers"]):
        h = F.conv1d(p(h), p.weight(w[f"feature_extractor.conv_layers.{i}.0.weight"]), stride=stride)
        h = layer_norm(h.transpose(1, 2), w, f"feature_extractor.conv_layers.{i}.2.1")
        h = F.gelu(h).transpose(1, 2)
    x = linear(layer_norm(h.transpose(1, 2), w, "layer_norm"), w, "post_extract_proj", p)
    pos = F.conv1d(p(x.transpose(1, 2)), p.weight(w["encoder.pos_conv.0.weight"]),
                   w["encoder.pos_conv.0.bias"], padding=cfg["conv_pos"] // 2,
                   groups=cfg["conv_pos_groups"])
    if cfg["conv_pos"] % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    N, T, D = x.shape
    H = cfg["encoder_attention_heads"]
    hd = D // H
    rel = w["encoder.layers.0.self_attn.relative_attention_bias.weight"]
    bias = rel[_buckets(T, cfg["num_buckets"], cfg["max_distance"], x.device)].permute(2, 0, 1)
    for i in range(cfg["encoder_layers"]):
        n = f"encoder.layers.{i}"
        y = layer_norm(x, w, n + ".self_attn_layer_norm")
        q, k, v = (linear(y, w, f"{n}.self_attn.{c}_proj", p).reshape(N, T, H, hd).transpose(1, 2)
                   for c in "qkv")
        gates = torch.sigmoid(linear(q, w, n + ".self_attn.grep_linear", p)
                              .reshape(N, H, T, 2, 4).sum(-1))
        gate = gates[..., :1] * (gates[..., 1:] * w[n + ".self_attn.grep_a"] - 1.0) + 2.0
        sim = torch.matmul(p(q * hd ** -0.5), p(k).transpose(-1, -2)) + gate * bias[None]
        a = torch.matmul(p(torch.softmax(sim, dim=-1)), p(v)).transpose(1, 2).reshape(N, T, D)
        x = x + linear(a, w, n + ".self_attn.out_proj", p)
        y = layer_norm(x, w, n + ".final_layer_norm")
        x = x + linear(F.gelu(linear(y, w, n + ".fc1", p)), w, n + ".fc2", p)
    return layer_norm(x, w, "encoder.layer_norm")


def layout(cfg: dict) -> list:
    """(name, shape, fan_in or 0, offset) of every weight of the Large layout:
    a weight with a fan-in is drawn N(0, 1/fan_in), a gain 1 + N(0, 0.1²), the
    rest N(0, 0.1²)."""
    D, F, H = cfg["encoder_embed_dim"], cfg["encoder_ffn_embed_dim"], cfg["encoder_attention_heads"]
    out, cin = [], 1
    for i, (dim, k, _) in enumerate(cfg["conv_feature_layers"]):
        out += [(f"feature_extractor.conv_layers.{i}.0.weight", (dim, cin, k), cin * k, 0.0),
                (f"feature_extractor.conv_layers.{i}.2.1.weight", (dim,), 0, 1.0),
                (f"feature_extractor.conv_layers.{i}.2.1.bias", (dim,), 0, 0.0)]
        cin = dim
    g = cfg["conv_pos_groups"]
    out += [("layer_norm.weight", (cin,), 0, 1.0), ("layer_norm.bias", (cin,), 0, 0.0),
            ("post_extract_proj.weight", (D, cin), cin, 0.0), ("post_extract_proj.bias", (D,), 0, 0.0),
            ("encoder.pos_conv.0.weight", (D, D // g, cfg["conv_pos"]), D // g * cfg["conv_pos"], 0.0),
            ("encoder.pos_conv.0.bias", (D,), 0, 0.0)]
    for i in range(cfg["encoder_layers"]):
        n = f"encoder.layers.{i}"
        out.append((n + ".self_attn.grep_a", (1, H, 1, 1), 0, 1.0))
        for c in "qkv":
            out += [(f"{n}.self_attn.{c}_proj.weight", (D, D), D, 0.0),
                    (f"{n}.self_attn.{c}_proj.bias", (D,), 0, 0.0)]
        out += [(n + ".self_attn.out_proj.weight", (D, D), D, 0.0),
                (n + ".self_attn.out_proj.bias", (D,), 0, 0.0)]
        if i == 0:
            out.append((n + ".self_attn.relative_attention_bias.weight",
                        (cfg["num_buckets"], H), 0, 0.0))
        out += [(n + ".self_attn.grep_linear.weight", (8, D // H), D // H, 0.0),
                (n + ".self_attn.grep_linear.bias", (8,), 0, 0.0),
                (n + ".self_attn_layer_norm.weight", (D,), 0, 1.0),
                (n + ".self_attn_layer_norm.bias", (D,), 0, 0.0),
                (n + ".fc1.weight", (F, D), D, 0.0), (n + ".fc1.bias", (F,), 0, 0.0),
                (n + ".fc2.weight", (D, F), F, 0.0), (n + ".fc2.bias", (D,), 0, 0.0),
                (n + ".final_layer_norm.weight", (D,), 0, 1.0),
                (n + ".final_layer_norm.bias", (D,), 0, 0.0)]
    return out + [("encoder.layer_norm.weight", (D,), 0, 1.0),
                  ("encoder.layer_norm.bias", (D,), 0, 0.0)]
