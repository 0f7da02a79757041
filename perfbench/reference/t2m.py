"""Text-to-motion MDM on HumanML3D (Tevet et al., "Human Motion Diffusion
Model", ICLR 2023; github.com/GuyTevet/motion-diffusion-model, `model/mdm.py`
with `cond_mode='text'` and `arch='trans_enc'`, the sizes of
`utils/parser_util.py`, the loop of `sample/generate.py`), plain float32
PyTorch.

Text: OpenAI CLIP ViT-B/32's text tower (`encode_text`): token embedding plus
learned positions → 12 pre-LN causal blocks of 8 heads (a quick-GELU MLP of
4 × width) → final LayerNorm → the hidden state at argmax(ids) (the end token
has the largest id) → a projection without bias.

Denoiser: x_t (B, 263, 1, T) → InputProcess (Linear 263 → 512 a frame) →
[token ; frames], the token = timestep MLP (sinusoidal table → Linear → SiLU →
Linear) + `embed_text` (Linear 512 → 512) of the text embedding → additive
sinusoidal positions over T + 1 → 8 post-norm encoder layers (4 heads, ff
1024, exact GELU) → the token dropped → OutputProcess (Linear 512 → 263).

Guidance: uncond + scale · (cond − uncond), the uncond pass's text zeroed
(`mask_cond`), both passes as one doubled batch. Sampling: ancestral DDPM over
the cosine schedule (`diffusion.ddpm`), its noise from a generator seeded with
the request's seed, x_T first, each draw made at the request's whole
(rows, 263, 1, T) and the followed rows kept.

Departures from upstream MDM, none of which touches the model's mathematics:

* captions are tokenized by `hash_tokenize` (words hashed into CLIP's id
  range, start and end tokens at CLIP's ids, zero padding to 77) in place of
  CLIP's BPE, whose vocabulary is not in the repository; upstream also
  truncates a caption at 20 words, which the traffic's captions never reach;
* the CLIP tower runs in float32, as the configuration states (upstream loads
  it in half precision and casts its output to float32);
* dropout (0.1 in the trunk and the positions) is off, as at inference;
* the weights are the benchmark's seeded random weights, by the port's names.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import diffusion
from .layers import (Precision, Weights, encoder_layer, layer_norm, linear, linear_layout,
                     no_tf32, norm_layout, sinusoidal_table, timestep_embedding, trunk_layout)


def hash_tokenize(texts: Sequence[str], context_length: int, vocab_size: int) -> np.ndarray:
    """[start, one id a word (1 + crc32(word) mod (vocab − 3)), end, 0-pad]; the
    start and end tokens are the two largest ids, lower-cased words split at
    white space, full stops and commas."""
    out = np.zeros((len(texts), context_length), np.int64)
    for i, text in enumerate(texts):
        words = text.lower().replace(".", " ").replace(",", " ").split()
        ids = [1 + zlib.crc32(w.encode()) % (vocab_size - 3) for w in words]
        ids = [vocab_size - 2] + ids[:context_length - 2] + [vocab_size - 1]
        out[i, :len(ids)] = ids
    return out


def clip_layout(clip: dict) -> list:
    """The text tower's weights, by the port's `ClipTextEncoder` names."""
    W = clip["width"]
    out = [("token_embedding", (clip["vocab_size"], W), 0, 0.0),
           ("position_embedding", (clip["context_length"], W), 0, 0.0)]
    for i in range(clip["layers"]):
        b = f"blocks.{i}"
        out += norm_layout(b + ".ln_1", W) + norm_layout(b + ".ln_2", W)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += linear_layout(f"{b}.attn.{name}", W, W)
        out += linear_layout(b + ".mlp_fc1", 4 * W, W) + linear_layout(b + ".mlp_fc2", W, 4 * W)
    return (out + norm_layout("ln_final", W)
            + [("text_projection.weight", (clip["projection_dim"], W), W, 0.0)])


def mdm_layout(cfg: dict) -> list:
    """The denoiser's weights, by the upstream (and the port's) names."""
    D, C = cfg["latent_dim"], cfg["njoints"]
    return (linear_layout("embed_timestep.time_embed.0", D, D)
            + linear_layout("embed_timestep.time_embed.2", D, D)
            + linear_layout("embed_text", D, cfg["clip"]["projection_dim"])
            + linear_layout("input_process.poseEmbedding", D, C)
            + trunk_layout(cfg) + linear_layout("output_process.poseFinal", C, D))


class TextToMotion:
    def __init__(self, cfg: dict, mdm: Weights, clip: Weights, device,
                 precision: str = "float32"):
        self.cfg, self.w, self.clip, self.device = cfg, mdm, clip, device
        self.p = Precision(precision)
        no_tf32()
        self.table = sinusoidal_table(cfg["diffusion_steps"], cfg["latent_dim"], device)
        self._positions: Dict[int, torch.Tensor] = {}

    def encode(self, ids: torch.Tensor) -> torch.Tensor:
        """(P, L) token ids → (P, projection_dim) text embeddings."""
        w, p, heads = self.clip, self.p, self.cfg["clip"]["heads"]
        P, L = ids.shape
        x = w["token_embedding"][ids] + w["position_embedding"][:L]
        hidden = torch.ones(L, L, dtype=torch.bool, device=ids.device).triu(1)
        for i in range(self.cfg["clip"]["layers"]):
            b = f"blocks.{i}"
            h = layer_norm(x, w, b + ".ln_1")
            q, k, v = (linear(h, w, f"{b}.attn.{n}_proj", p).reshape(P, L, heads, -1)
                       .transpose(1, 2) for n in ("q", "k", "v"))
            scores = torch.matmul(p(q), p(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
            att = torch.softmax(scores.masked_fill(hidden, float("-inf")), dim=-1)
            a = torch.matmul(p(att), p(v)).transpose(1, 2).reshape(P, L, -1)
            x = x + linear(a, w, b + ".attn.out_proj", p)
            h = linear(layer_norm(x, w, b + ".ln_2"), w, b + ".mlp_fc1", p)
            x = x + linear(h * torch.sigmoid(1.702 * h), w, b + ".mlp_fc2", p)
        x = layer_norm(x, w, "ln_final")
        pooled = x[torch.arange(P, device=ids.device), ids.argmax(dim=-1)]
        return linear(pooled, w, "text_projection", p)

    def _position_table(self, n: int) -> torch.Tensor:
        if n not in self._positions:
            self._positions[n] = sinusoidal_table(n, self.cfg["latent_dim"], self.device)
        return self._positions[n]

    def denoise(self, x: torch.Tensor, t: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """x_t (B, C, 1, T), timesteps (B,), text (B, projection_dim) → x0 (B, C, 1, T)."""
        w, p, cfg = self.w, self.p, self.cfg
        T = x.shape[-1]
        token = timestep_embedding(t, self.table, w, p) + linear(text, w, "embed_text", p)
        frames = linear(x[:, :, 0].transpose(1, 2), w, "input_process.poseEmbedding", p)
        seq = torch.cat([token[:, None], frames], dim=1) + self._position_table(T + 1)
        for i in range(cfg["num_layers"]):
            seq = encoder_layer(seq, w, f"seqTransEncoder.layers.{i}", cfg["num_heads"], p)
        return linear(seq[:, 1:], w, "output_process.poseFinal", p).transpose(1, 2)[:, :, None]

    def guided(self, x: torch.Tensor, t: torch.Tensor, text: torch.Tensor,
               scale: float) -> torch.Tensor:
        """uncond + scale · (cond − uncond), the two passes as one doubled batch."""
        B = x.shape[0]
        out = self.denoise(torch.cat([x, x]), torch.cat([t, t]),
                           torch.cat([text, torch.zeros_like(text)]))
        return out[B:] + scale * (out[:B] - out[B:])

    def sample(self, ids: torch.Tensor, rows: List[int], full: int, frames: int, seed: int,
               scale: float, sched) -> torch.Tensor:
        """The followed `rows` of a request of `full` rows, each row's prompt
        ids given (len(rows), L): normalized hml_vec (len(rows), frames, C)."""
        text = self.encode(ids)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = diffusion.ddpm(lambda x, t: self.guided(x, t, text, scale), sched,
                           (full, self.cfg["njoints"], 1, frames), rows, gen, self.device)
        return x[:, :, 0].transpose(1, 2)
