"""WavLM → gesture-framework adapters.

Port of `diffusestylegesture_tpu/models/wavlm/adapters.py`:

* ZEGGS `make_zeggs_wavlm_fn` (reference `main/mydiffusion_zeggs/sample.py:44-48`):
  raw windows → `extract_features` → linear interpolation (align_corners) to
  n_poses frames. The reference does NOT apply the checkpoint's
  `cfg.normalize` wav layer-norm here; that quirk is kept.
* BEAT/TWH `make_twh_wavlm_fn` (reference `BEAT-TWH-main/process/
  process_TWH_bvh.py:81-98`): layer-norm the whole wav, zero-pad it to whole
  5 s chunks, run the chunks as one batch and concatenate their features. A
  wav of an exact multiple of 5 s gets one more all-zero chunk
  (`num = len // chunk + 1`), as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .model import WavLM, interpolate_linear


def make_zeggs_wavlm_fn(n_poses: int = 88) -> Callable[[WavLM, torch.Tensor], torch.Tensor]:
    """Returns wavlm_apply(wavlm, windows (W, S)) → (W, n_poses, D)."""

    def apply(wavlm: WavLM, windows: torch.Tensor) -> torch.Tensor:
        return interpolate_linear(wavlm(windows), n_poses)

    return apply


def make_twh_wavlm_fn(chunk_secs: int = 5,
                      sr: int = 16000) -> Callable[[WavLM, torch.Tensor], torch.Tensor]:
    """Returns wavlm_apply(wavlm, wav (S,)) → (T', D) whole-clip features."""

    def apply(wavlm: WavLM, wav: torch.Tensor) -> torch.Tensor:
        wav = wav.float()
        # population variance and rsqrt(var + 1e-5), as jnp.var / lax.rsqrt
        wav = (wav - wav.mean()) * torch.rsqrt(wav.var(unbiased=False) + 1e-5)
        chunk = sr * chunk_secs
        num = wav.shape[0] // chunk + 1
        rep = wavlm(F.pad(wav, (0, chunk * num - wav.shape[0])).reshape(num, chunk))
        return rep.reshape(-1, rep.shape[-1])

    return apply
