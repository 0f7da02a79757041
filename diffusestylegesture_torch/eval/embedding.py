"""The gesture autoencoder whose latent space FGD is computed in.

Port of `diffusestylegesture_tpu/eval/embedding.py`. The gesture literature
takes the Fréchet Gesture Distance over the latent of a motion autoencoder
trained on ground-truth gestures (Yoon et al. 2020), not over raw poses:

  * `GestureAutoencoder`: a 1-D conv encoder over fixed-length pose windows →
    latent, and a mirrored transposed-conv decoder;
  * `train_autoencoder`: MSE reconstruction training on the card, one step
    captured as a CUDA graph and replayed (`utils/graphs.py::CapturedStep`),
    the counterpart of the JAX package's single `lax.scan` over all steps;
  * `embed_windows`: (N, W, D) windows → (N, latent) features.

The public functions keep the JAX layout, (batch, frames, features). Two
traps of the flax → torch mapping, each held by the tests at odd window
lengths too:

  * flax `nn.Conv(..., strides=2)` pads 'SAME': out = ceil(n/2), the total pad
    (out − 1)·2 + k − n split low = total // 2, high = the rest, which is (1, 2)
    at k 5 and n 40. `Conv1d(padding=2)` gives the same length with windows
    shifted by one frame, so the pad is explicit.
  * flax `nn.ConvTranspose` ('SAME', `transpose_kernel=False`) is a
    correlation of the stride-dilated input padded (3, 2) at k 5, stride 2,
    with the kernel as it is: out = 2n. `ConvTranspose1d` is the adjoint of a
    correlation, so the converted kernel is flipped along its taps
    (`models/convert.py::autoencoder_state_dict_from_flax`), and the output
    starts k − 1 − 3 = 1 frame into the full transposed convolution.

flax's `nn.gelu` is the tanh approximation. The optimizer is `optax.adam(lr)`:
the port's flat `AdamW` with no decay and no anneal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..train.state import TrainConfig, TrainState
from ..utils.graphs import CapturedStep

KERNEL, STRIDE = 5, 2
# flax ConvTranspose 'SAME' at kernel 5, stride 2 (lax._conv_transpose_padding):
# the dilated input is padded 3 before; the output is 2n frames from offset k - 1 - 3
TRANSPOSE_PAD_LOW = 3


@dataclasses.dataclass(frozen=True)
class AEConfig:
    window: int = 40
    feat_dim: int = 1141
    hidden: int = 256
    latent: int = 128


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _same_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """flax 'SAME' convolution over (B, C, n): ceil(n / stride) frames."""
    n = x.shape[-1]
    total = max((-(-n // STRIDE) - 1) * STRIDE + KERNEL - n, 0)
    return conv(F.pad(x, (total // 2, total - total // 2)))


def _same_conv_transpose(deconv: nn.ConvTranspose1d, x: torch.Tensor) -> torch.Tensor:
    """flax 'SAME' transposed convolution over (B, C, n): 2n frames."""
    n = x.shape[-1]
    off = KERNEL - 1 - TRANSPOSE_PAD_LOW
    return deconv(x)[..., off: off + STRIDE * n]


class Encoder(nn.Module):
    def __init__(self, cfg: AEConfig):
        super().__init__()
        self.conv1 = nn.Conv1d(cfg.feat_dim, cfg.hidden, KERNEL, STRIDE)
        self.conv2 = nn.Conv1d(cfg.hidden, cfg.hidden, KERNEL, STRIDE)
        self.proj = nn.Linear(-(-cfg.window // 4) * cfg.hidden, cfg.latent)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, W, D)
        h = _gelu(_same_conv(self.conv1, x.transpose(1, 2)))
        h = _gelu(_same_conv(self.conv2, h))
        return self.proj(h.transpose(1, 2).reshape(x.shape[0], -1))  # flattened frame-major


class Decoder(nn.Module):
    def __init__(self, cfg: AEConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Linear(cfg.latent, -(-cfg.window // 4) * cfg.hidden)
        self.deconv1 = nn.ConvTranspose1d(cfg.hidden, cfg.hidden, KERNEL, STRIDE)
        self.deconv2 = nn.ConvTranspose1d(cfg.hidden, cfg.feat_dim, KERNEL, STRIDE)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.proj(z)).reshape(z.shape[0], -1, self.cfg.hidden).transpose(1, 2)
        h = _gelu(_same_conv_transpose(self.deconv1, h))
        h = _same_conv_transpose(self.deconv2, h)
        return h.transpose(1, 2)[:, : self.cfg.window]


class GestureAutoencoder(nn.Module):
    """forward(x (B, W, D)) → (reconstruction (B, W, D), latent (B, latent))."""

    def __init__(self, cfg: AEConfig = AEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encoder(x)
        return self.decoder(z), z


def make_autoencoder_step(state: TrainState, data: torch.Tensor, batch_size: int) -> Callable:
    """step(generator, *, idx=None) → {'loss'}: one Adam step on a batch of
    `data` rows drawn with replacement from `generator` (`idx` injects them),
    every update written into the state's buffers (capturable)."""

    def step(generator, *, idx=None):
        if idx is None:
            idx = torch.randint(0, data.shape[0], (batch_size,), generator=generator,
                                device=data.device)
        batch = data.index_select(0, idx)
        state.params.grad.zero_()
        recon, _ = state.model(batch)
        loss = torch.mean((recon - batch) ** 2)
        loss.backward()
        state.optimizer.step()
        return {"loss": loss.detach()}

    return step


def train_autoencoder(windows: np.ndarray, cfg: AEConfig, num_steps: int = 500,
                      batch_size: int = 32, lr: float = 1e-3, seed: int = 0,
                      device="cuda") -> Tuple[GestureAutoencoder, float]:
    """Train on (N, W, D) ground-truth windows → (model, final loss); weights
    from `seed`, batches drawn with replacement. `num_steps <= 0` returns the
    untrained model and inf. On a card the step is captured once and replayed
    `num_steps - 1` times, with cuDNN held to its deterministic algorithms so
    that a replay repeats the eager step bit for bit."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = GestureAutoencoder(cfg)
    model = model.to(dev)
    if num_steps <= 0:
        return model.eval(), float("inf")
    state = TrainState(model, TrainConfig(lr=lr))  # optax.adam(lr): no decay, no anneal
    data = torch.as_tensor(np.asarray(windows, np.float32), device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    step = make_autoencoder_step(state, data, batch_size)
    run = CapturedStep(lambda: step(generator), dev, [generator])
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        loss = float(run(num_steps)["loss"])
    return model.eval(), loss


@torch.no_grad()
def embed_windows(model: GestureAutoencoder, windows: np.ndarray,
                  batch: int = 256) -> np.ndarray:
    """(N, W, D) → (N, latent) embedding features, on the model's device."""
    dev = next(model.parameters()).device
    out = [model.encoder(torch.as_tensor(np.asarray(windows[s: s + batch], np.float32),
                                         device=dev)).cpu().numpy()
           for s in range(0, len(windows), batch)]
    return np.concatenate(out, 0)
