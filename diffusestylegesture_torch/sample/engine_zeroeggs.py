"""ZeroEGGS generation engine: stylized RNN gesture synthesis, on the card by default.

Port of `diffusestylegesture_tpu/sample/engine_zeroeggs.py`
(`ubisoft-laforge-ZeroEGGS-main/ZEGGS/generate.py:20-330`):
  * style encodings from example-motion feature matrices (the
    [root_vel | root_vrt | lpos | ltxy | lvel | lvrt | zeros(3)] layout, the
    gaze slot zeroed, `generate.py:228-246`), or given embedding vectors;
  * style blending: "add" = ratio-weighted sum of the embeddings
    (`generate.py:272-281`), "stitch" = a per-frame piecewise-constant
    schedule split in proportion to the ratios (`generate.py:253-270`);
  * the first-pose state from a featurized BVH frame; speech encoding →
    decoder rollout → BVH through the shared writer (`cli/zeroeggs.py`).

Audio features come precomputed (`data/zeroeggs_data.audio_features`) and are
z-normalized with the dataset's stats, as in the reference.

The rollout is sequential: one decoder step a frame (750 for 12.5 s at 60
fps), each a few dozen small launches, so eagerly it waits on the host. On a
CUDA device `ZeroEggsGenerator` captures one step as a CUDA graph
(`CapturedRollout`: the step reads its frame's inputs through a device index
and writes its state and outputs in place) and replays it once a frame;
`graphs=False` runs the same step function eagerly, which gives the same
numbers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.zeroeggs import ZeroEGGS, ZeroEGGSDecoder, stats_to_device
from ..utils.graphs import GraphSet


def example_feature_vec(root_vel, root_vrt, lpos, ltxy, lvel, lvrt, anim_input_mean,
                        anim_input_std) -> np.ndarray:
    """(T, 15J+9) style-example features (`generate.py:222-246`)."""
    T = len(root_vel)
    vec = np.concatenate([root_vel.reshape(T, -1), root_vrt.reshape(T, -1), lpos.reshape(T, -1),
                          ltxy.reshape(T, -1), lvel.reshape(T, -1), lvrt.reshape(T, -1),
                          np.zeros((T, 3), np.float32)], axis=1)
    return (vec - anim_input_mean) / anim_input_std


def split_by_ratio(n: int, ratios: Sequence[float]) -> List[np.ndarray]:
    """Consecutive index segments of range(n) in proportion to the ratios."""
    ratios = np.asarray(ratios, np.float64)
    bounds = np.floor(np.cumsum(ratios / ratios.sum()) * n).astype(int)
    out, start = [], 0
    for b in bounds:
        out.append(np.arange(start, b))
        start = b
    if start < n:
        out[-1] = np.arange(out[-1][0] if len(out[-1]) else start, n)
    return out


def blend_style_encodings(encodings: Sequence[torch.Tensor], n_frames: int,
                          blend_type: str = "add",
                          blend_ratio: Optional[Sequence[float]] = None) -> torch.Tensor:
    """(B, T, E) per-frame style schedule (`generate.py:253-281,329-330`)."""
    blend_ratio = blend_ratio or [1.0 / len(encodings)] * len(encodings)
    if len(encodings) == 1:
        enc = encodings[0]
        return enc[:, None, :].expand(enc.shape[0], n_frames, enc.shape[1])
    if blend_type == "add":
        stacked = torch.stack(list(encodings), dim=1)  # (B, K, E)
        w = torch.as_tensor(blend_ratio, dtype=torch.float32, device=stacked.device)
        enc = torch.einsum("bke,k->be", stacked, w)
        return enc[:, None, :].expand(enc.shape[0], n_frames, enc.shape[1])
    if blend_type == "stitch":
        segs = split_by_ratio(n_frames, blend_ratio)
        return torch.cat([enc[:, None, :].expand(enc.shape[0], len(seg), enc.shape[1])
                          for enc, seg in zip(encodings, segs)], dim=1)
    raise ValueError(f"unknown blend type {blend_type!r} (add | stitch)")


class CapturedRollout:
    """The decoder's rollout as one step function over buffers: the frame's
    inputs are read through a device index, the carry and the outputs are
    written in place. On a CUDA device the step is captured once per (batch,
    frames) and replayed a frame at a time; eagerly (`graphs=False`, and on
    the CPU) the same function runs. Returns what `ZeroEGGSDecoder.forward`
    returns, as tensors owned by the caller."""

    def __init__(self, decoder: ZeroEGGSDecoder, device: torch.device, graphs: bool):
        self.decoder, self.device, self.graphs = decoder, device, graphs
        self._key = None

    @property
    def capture_seconds(self) -> float:
        return self._graph_set.capture_seconds if self._key is not None and self.graphs else 0.0

    def _build(self, shapes: Tuple, stats: Dict[str, torch.Tensor]) -> None:
        (state_shapes, cell_shape, B, T, S, E) = shapes
        dev, J = self.device, self.decoder.cfg.njoints
        zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        self.state = [zeros(*s) for s in state_shapes] + [zeros(*cell_shape)]
        self.gaze, self.speech, self.style = zeros(B, T, 3), zeros(B, T, S), zeros(B, T, E)
        self.outs = [zeros(B, T, 3), zeros(B, T, 4), zeros(B, T, J, 3), zeros(B, T, J, 2, 3)]
        self.idx = torch.ones(1, dtype=torch.long, device=dev)
        self.stats = stats

        def step():
            i = self.idx
            carry = self.decoder.step(tuple(self.state), self.speech.index_select(1, i)[:, 0],
                                      self.style.index_select(1, i)[:, 0],
                                      self.gaze.index_select(1, i)[:, 0], self.stats)
            for buf, value in zip(self.state, carry):
                buf.copy_(value)
            for out, value in zip(self.outs, (carry[0], carry[1], carry[4], carry[5])):
                out.index_copy_(1, i, value[:, None])
            self.idx.add_(1)

        self.step = step
        if self.graphs:
            self._graph_set = GraphSet(dev)
            self.graph, _ = self._graph_set.capture(step, prepare=lambda: self.idx.fill_(1),
                                                    what="zeroeggs rollout step")

    @torch.inference_mode()
    def __call__(self, initial_state: Sequence[torch.Tensor], gaze_pos: torch.Tensor,
                 speech: torch.Tensor, style: torch.Tensor, stats: Dict[str, torch.Tensor]):
        B, T = speech.shape[:2]
        carry = self.decoder.initial_carry(initial_state, gaze_pos[:, 0], style[:, 0], stats)
        key = (tuple(tuple(c.shape) for c in carry), T, speech.shape[2], style.shape[2],
               id(stats))
        if key != self._key:
            self._build((tuple(tuple(c.shape) for c in carry[:-1]), tuple(carry[-1].shape), B, T,
                         speech.shape[2], style.shape[2]), stats)
            self._key = key
        for buf, value in zip(self.state, carry):
            buf.copy_(value)
        for buf, value in ((self.gaze, gaze_pos), (self.speech, speech), (self.style, style)):
            buf.copy_(value)
        for out, value in zip(self.outs, (carry[0], carry[1], carry[4], carry[5])):
            out[:, 0].copy_(value)
        self.idx.fill_(1)
        if self.graphs:
            self.graph.replay(T - 1)
        else:
            for _ in range(T - 1):
                self.step()
        return tuple(out.clone() for out in self.outs)


class ZeroEggsGenerator:
    """Style encoding and generation with a trained `ZeroEGGS` on `device`
    ("cuda" unless the caller asks for the CPU). `stats` are the stats.npz
    arrays. `graphs`: None captures the rollout step on a CUDA device and runs
    it eagerly on the CPU; False runs eagerly on the card too."""

    def __init__(self, model: ZeroEGGS, stats: Dict[str, np.ndarray],
                 device: Union[str, torch.device] = "cuda", graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.cfg = model.cfg
        self.model = model.to(self.device).eval()
        self.stats = stats_to_device(stats, self.device)
        self.rollout = CapturedRollout(self.model.decoder, self.device, self.graphs)

    @torch.inference_mode()
    def encode_style(self, example_features: np.ndarray,
                     generator: Optional[torch.Generator] = None, temperature: float = 1.0,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(T, 15J+9) normalized example → (1, E) style code, sampled from the
        VAE with `generator` (or the given `eps`); its mean with neither."""
        x = torch.as_tensor(np.asarray(example_features, np.float32), device=self.device)[None]
        z, _, _ = self.model.style(x, generator, temperature=temperature, eps=eps)
        return z

    @torch.inference_mode()
    def generate(self, audio_features: np.ndarray, styles: Sequence, first_pose_state: Tuple,
                 gaze_pos: Optional[np.ndarray] = None, blend_type: str = "add",
                 blend_ratio: Optional[Sequence[float]] = None):
        """(T, A) un-normalized audio features, style codes (1, E) each, the
        first frame's 8-tuple → (root_pos, root_rot, lpos, ltxy), each (1, T, …)
        on the device."""
        st, dev = self.stats, self.device
        af = torch.as_tensor(np.asarray(audio_features, np.float32), device=dev)
        af = (af - st["audio_input_mean"]) / st["audio_input_std"]
        speech = self.model.speech(af[None])
        T = speech.shape[1]
        style_seq = blend_style_encodings(
            [torch.atleast_2d(torch.as_tensor(s, dtype=torch.float32, device=dev))
             for s in styles], T, blend_type, blend_ratio)
        gaze = (torch.zeros((1, T, 3), device=dev) if gaze_pos is None
                else torch.as_tensor(np.asarray(gaze_pos, np.float32), device=dev))
        init = [torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]
                for x in first_pose_state]
        return self.rollout(init, gaze, speech, style_seq, st)

    @property
    def capture_seconds(self) -> float:
        return self.rollout.capture_seconds
