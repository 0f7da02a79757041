"""CLIP text encoder (MDM-legacy text-to-motion conditioning), in plain PyTorch.

Port of `diffusestylegesture_tpu/models/clip_text.py`. The reference's
MDM-legacy pipeline conditions on CLIP ViT-B/32 text features (`clip_dim`
512; `load_model_wo_clip` drops `clip_model.*` at load). OpenAI CLIP
`encode_text`: token embedding + learned positions -> pre-LN causal blocks
(quick_gelu MLP) -> final LayerNorm -> the hidden state at `argmax(ids)` (EOT
has the highest id) -> a linear projection without bias. The JAX package left
it to XLA; here it runs plain torch ops (no kernel).

`convert_hf_clip_text` / `convert_openai_clip_text` turn a HuggingFace
`CLIPTextModelWithProjection` or an OpenAI `clip` state dict into this
module's state dict; `clip_state_dict_from_flax` the JAX package's params
(also as the flat npz of its `save_params_npz`). `hash_tokenize` is the JAX
package's BPE-free tokenizer, copied exactly.

`make_caption_encoder` builds the frozen `captions -> (N, projection_dim)`
callable and its spec. Without `params_path` the port initialises the encoder
from a seeded `torch.Generator`; the JAX package's `PRNGKey(seed)` encoder
cannot be rebuilt without JAX, so a spec that names only a seed is turned
into a weights file by `scripts/convert_orbax_to_torch.py`.
"""
from __future__ import annotations

import dataclasses
import math
import os
import zlib
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    context_length: int = 77
    projection_dim: int = 512


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        B, T, W = x.shape
        hd = W // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, T, W)
        return self.out_proj(out)


class ClipBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = ClipAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc1 = nn.Linear(width, 4 * width)
        self.mlp_fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp_fc2(quick_gelu(self.mlp_fc1(self.ln_2(x))))


class ClipTextEncoder(nn.Module):
    """forward(input_ids (B, T) int) -> (B, projection_dim) text embeddings."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width))
        self.position_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.blocks = nn.ModuleList(ClipBlock(cfg.width, cfg.heads) for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Linear(cfg.width, cfg.projection_dim, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init in the JAX module's families: normal(0.02) tokens,
        normal(0.01) positions, lecun-normal Dense kernels, zero biases, unit
        LayerNorms (not the same draws)."""
        self.token_embedding.copy_(torch.randn(self.token_embedding.shape, generator=generator)
                                   * 0.02)
        self.position_embedding.copy_(
            torch.randn(self.position_embedding.shape, generator=generator) * 0.01)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(m.in_features))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        input_ids = input_ids.long()
        T = input_ids.shape[1]
        x = self.token_embedding[input_ids] + self.position_embedding[:T]
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        for block in self.blocks:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = torch.argmax(input_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.text_projection(pooled)


# ---- state-dict converters ------------------------------------------------------

def _f32(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _copy_linear(out: Dict, dst: str, sd: Mapping, src: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if bias:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def convert_hf_clip_text(sd: Mapping, layers: int = 12) -> Dict[str, torch.Tensor]:
    """HuggingFace `CLIPTextModelWithProjection.state_dict()` -> this module's."""
    base = "text_model"
    out = {"token_embedding": _f32(sd[f"{base}.embeddings.token_embedding.weight"]),
           "position_embedding": _f32(sd[f"{base}.embeddings.position_embedding.weight"]),
           "text_projection.weight": _f32(sd["text_projection.weight"])}
    _copy_linear(out, "ln_final", sd, f"{base}.final_layer_norm")
    for i in range(layers):
        lp, bp = f"{base}.encoder.layers.{i}", f"blocks.{i}"
        _copy_linear(out, f"{bp}.ln_1", sd, f"{lp}.layer_norm1")
        _copy_linear(out, f"{bp}.ln_2", sd, f"{lp}.layer_norm2")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy_linear(out, f"{bp}.attn.{name}", sd, f"{lp}.self_attn.{name}")
        _copy_linear(out, f"{bp}.mlp_fc1", sd, f"{lp}.mlp.fc1")
        _copy_linear(out, f"{bp}.mlp_fc2", sd, f"{lp}.mlp.fc2")
    return out


def convert_openai_clip_text(sd: Mapping, layers: int = 12) -> Dict[str, torch.Tensor]:
    """OpenAI `clip` state dict (what `clip.load` returns, fused
    `in_proj_weight`, `text_projection` as (width, proj)) -> this module's."""
    out = {"token_embedding": _f32(sd["token_embedding.weight"]),
           "position_embedding": _f32(sd["positional_embedding"]),
           "text_projection.weight": _f32(sd["text_projection"]).T.contiguous()}
    _copy_linear(out, "ln_final", sd, "ln_final")
    for i in range(layers):
        lp, bp = f"transformer.resblocks.{i}", f"blocks.{i}"
        _copy_linear(out, f"{bp}.ln_1", sd, f"{lp}.ln_1")
        _copy_linear(out, f"{bp}.ln_2", sd, f"{lp}.ln_2")
        w = _f32(sd[f"{lp}.attn.in_proj_weight"]).chunk(3, dim=0)
        b = _f32(sd[f"{lp}.attn.in_proj_bias"]).chunk(3, dim=0)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{bp}.attn.{name}.weight"] = w[j].contiguous()
            out[f"{bp}.attn.{name}.bias"] = b[j].contiguous()
        _copy_linear(out, f"{bp}.attn.out_proj", sd, f"{lp}.attn.out_proj")
        _copy_linear(out, f"{bp}.mlp_fc1", sd, f"{lp}.mlp.c_fc")
        _copy_linear(out, f"{bp}.mlp_fc2", sd, f"{lp}.mlp.c_proj")
    return out


def clip_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `ClipTextEncoder` params (nested dicts of arrays) -> this module's."""
    p = params["params"] if "params" in params else params
    out = {"token_embedding": _f32(p["token_embedding"]),
           "position_embedding": _f32(p["position_embedding"]),
           "text_projection.weight": _f32(np.asarray(p["text_projection"]["kernel"]).T),
           "ln_final.weight": _f32(p["ln_final"]["scale"]),
           "ln_final.bias": _f32(p["ln_final"]["bias"])}
    layers = len([k for k in p if k.startswith("block")])
    for i in range(layers):
        lp, bp = p[f"block{i}"], f"blocks.{i}"

        def dense(dst, node):
            out[f"{dst}.weight"] = _f32(np.asarray(node["kernel"]).T)
            out[f"{dst}.bias"] = _f32(node["bias"])

        for ln in ("ln_1", "ln_2"):
            out[f"{bp}.{ln}.weight"] = _f32(lp[ln]["scale"])
            out[f"{bp}.{ln}.bias"] = _f32(lp[ln]["bias"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{bp}.attn.{name}", lp["attn"][name])
        dense(f"{bp}.mlp_fc1", lp["mlp_fc1"])
        dense(f"{bp}.mlp_fc2", lp["mlp_fc2"])
    return out


def load_flat_npz(path: str) -> dict:
    """The flat 'a/b/c'-keyed npz of the JAX package's `save_params_npz` as a
    nested dict of arrays."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return out


def load_clip_weights(path: str) -> Dict[str, torch.Tensor]:
    """A text encoder's weights: this module's state dict (`.pt`) or the JAX
    package's flat npz of its params (`.npz`)."""
    if path.endswith(".npz"):
        return clip_state_dict_from_flax(load_flat_npz(path))
    return torch.load(path, map_location="cpu", weights_only=True)


SOT_TOKEN = 49406  # CLIP '<|startoftext|>'
EOT_TOKEN = 49407  # '<|endoftext|>', the largest id, so argmax finds it


def hash_tokenize(texts, context_length: int = 77, vocab_size: int = 49408) -> np.ndarray:
    """Deterministic word-hash tokenizer, the BPE-free stand-in when CLIP's
    vocabulary is not available (as the JAX package's): [SOT, ids..., EOT,
    0-pad], EOT at the largest id so the encoder's argmax pooling lands on it.
    Not CLIP-vocabulary compatible: pair it with a consistently trained
    encoder, never with converted OpenAI / HF weights."""
    sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        words = text.lower().replace(".", " ").replace(",", " ").split()
        ids = [1 + zlib.crc32(w.encode()) % (vocab_size - 3) for w in words]
        ids = [sot] + ids[: context_length - 2] + [eot]
        out[i, : len(ids)] = ids
    return out


class SeedOnlyEncoderError(ValueError):
    """A caption-encoder spec names only a JAX PRNG seed."""


def make_caption_encoder(params_path: Optional[str] = None, *, seed: int = 0,
                         width: int = 512, layers: int = 12, heads: int = 8,
                         vocab_size: int = 49408, projection_dim: int = 512,
                         context_length: int = 77, tokenizer_dir: Optional[str] = None,
                         device: Union[str, torch.device] = "cuda", **_):
    """(`captions -> (N, projection_dim) float32 np.ndarray`, its spec); the
    callable's `encoder` attribute is the `ClipTextEncoder` and its `tokenize`
    the captions → (N, context_length) int32 ids function it applies.

    params_path: the encoder's weights (`load_clip_weights`: a `.pt` state
    dict or the JAX package's npz); with `tokenizer_dir`, the captions are
    tokenised by `transformers.CLIPTokenizer` (imported here, when asked
    for), else by `hash_tokenize`. Without params_path: the encoder is
    initialised from `torch.Generator().manual_seed(seed)`; the caller
    (`cli/train_t2m.py`) saves its weights and names them in the spec.
    """
    dev = resolve_device(device)
    cfg = ClipTextConfig(vocab_size=vocab_size, width=width, layers=layers, heads=heads,
                         context_length=context_length, projection_dim=projection_dim)
    enc = ClipTextEncoder(cfg, torch.Generator().manual_seed(seed))
    if params_path:
        enc.load_state_dict(load_clip_weights(params_path))
    enc = enc.to(dev).eval().requires_grad_(False)

    if tokenizer_dir:
        try:
            from transformers import CLIPTokenizer
        except ImportError as e:
            raise ImportError("tokenizer_dir needs the `transformers` package (its "
                              "CLIPTokenizer); without it, use the hash tokenizer "
                              "(no tokenizer_dir)") from e
        tok = CLIPTokenizer.from_pretrained(tokenizer_dir)

        def tokenize(texts):
            return np.asarray(tok(list(texts), padding="max_length", truncation=True,
                                  max_length=context_length)["input_ids"], np.int32)
    else:
        def tokenize(texts):
            return hash_tokenize(texts, context_length, vocab_size)

    def encode(texts) -> np.ndarray:
        ids = torch.from_numpy(tokenize(list(texts))).to(dev)
        with torch.no_grad():
            return enc(ids).float().cpu().numpy()

    encode.encoder, encode.tokenize = enc, tokenize
    spec = {"params_path": params_path, "seed": seed, "width": width, "layers": layers,
            "heads": heads, "vocab_size": vocab_size, "projection_dim": projection_dim,
            "context_length": context_length, "tokenizer_dir": tokenizer_dir}
    return encode, spec


def caption_encoder_from_spec(spec: Mapping[str, Any], base_dir: str = "",
                              device: Union[str, torch.device] = "cuda"):
    """`make_caption_encoder` from a `t2m_config.json` "clip" spec. A relative
    `params_path` is taken from `base_dir` (the save dir). A spec that names
    only a seed (a JAX `train_t2m` save dir) raises: its encoder is the JAX
    `PRNGKey(seed)` init, which `scripts/convert_orbax_to_torch.py` writes out."""
    path = spec.get("params_path")
    if not path:
        raise SeedOnlyEncoderError(
            f"the caption encoder's spec names only seed {spec.get('seed')} (a JAX train_t2m "
            "save dir, whose encoder is jax.random.PRNGKey(seed)'s init); the port cannot "
            "rebuild it without JAX: run scripts/convert_orbax_to_torch.py on the save dir, "
            "which writes the encoder's weights and names them in t2m_config.json")
    if not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(base_dir, path)
    return make_caption_encoder(**{**spec, "params_path": path}, device=device)
