"""ZeroEGGS RNN gesture generator (the reference's third sub-project).

Port of `diffusestylegesture_tpu/models/zeroeggs.py`
(`ubisoft-laforge-ZeroEGGS-main/ZEGGS/modules.py`):
  * `SpeechEncoder` (`modules.py:237-260`): 1×1 conv → 31-wide
    replicate-padded conv → linear, ELU;
  * `StyleEncoderGRU` (`modules.py:295-331`): two 3-wide convs + ReLU →
    bidirectional GRU → last-step projection; `StyleEncoderAttn`
    (`modules.py:334-408`): convs + LayerNorm + positional encoding + one
    FFT block + mean pooling; `StyleEncoderVAE` (`modules.py:266-292`) with
    the temperature-scaled reparameterization, its noise drawn from an
    explicit generator (or handed in);
  * `CellStateEncoder` (`modules.py:218-231`) and `RecurrentDecoderNormal`
    (`modules.py:153-173`): torch's GRU parameterization (separate input and
    hidden biases), which the JAX `TorchGRU` / `TorchGRUCell` copy one to
    one, so their counterparts here are torch's own `nn.GRU` / `nn.GRUCell`;
  * `vectorize_input` / `devectorize_output` (`modules.py:666-730`);
  * `ZeroEGGSDecoder` (`Decoder.forward`, `modules.py:49-150`): the JAX
    `lax.scan` rollout is a loop over one step function, frame 0 kept as
    given; `sample/engine_zeroeggs.py` captures that step as a CUDA graph;
  * `kl_divergence`, `kl_weight` (`modules.py:733-777`) and the train step of
    `make_zeroeggs_train_step` with an optax-exact RAdam.

The JAX package has no Pallas kernel here: the port runs plain torch (cuDNN /
cuBLAS convolutions, GRU cells and linear layers). The speech encoder's
dropout is left out, as the JAX train step never turns it on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..motion import quat
from ..train.state import FlatParams
from .embeddings import sinusoidal_pe
from .transformer import TorchMultiheadAttention


def _conv_same(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """(B, T, C) through a 1-D conv over T."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class SpeechEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.layer0 = nn.Conv1d(input_size, hidden_size, 1)
        self.layer1 = nn.Conv1d(hidden_size, output_size, 31)
        self.layer2 = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, A) normalized audio features → (B, T, S)."""
        h = F.elu(_conv_same(x, self.layer0))
        h = F.pad(h.transpose(1, 2), (15, 15), mode="replicate")  # torch 'replicate' padding
        h = F.elu(self.layer1(h).transpose(1, 2))
        return F.elu(self.layer2(h))


class StyleEncoderGRU(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, out_size: int):
        super().__init__()
        self.conv0 = nn.Conv1d(input_size, hidden_size, 3, padding=1)
        self.conv1 = nn.Conv1d(hidden_size, hidden_size, 3, padding=1)
        self.rnn = nn.GRU(hidden_size, hidden_size, 1, batch_first=True, bidirectional=True)
        self.projection = nn.Linear(2 * hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_conv_same(x, self.conv0))
        h = F.relu(_conv_same(h, self.conv1))
        ys, _ = self.rnn(h)
        return self.projection(ys[:, -1])


class PositionWiseConvFF(nn.Module):
    """(`modules.py:548-601`): two 3-wide convs + ReLU, residual + LayerNorm."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.conv0 = nn.Conv1d(hidden_size, hidden_size, 3, padding=1)
        self.conv1 = nn.Conv1d(hidden_size, hidden_size, 3, padding=1)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_same(F.relu(_conv_same(x, self.conv0)), self.conv1)
        return self.layer_norm(h + x)


class FFTBlock(nn.Module):
    """(`modules.py:472-501`): post-LN multi-head attention (4 heads) + conv
    feed-forward. The generate path runs whole sequences (the padding mask is
    all False, `modules.py:387-399`), so no key-padding mask."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.mha = TorchMultiheadAttention(hidden_size, 4)
        self.attn_norm = nn.LayerNorm(hidden_size, eps=1e-5)
        self.ff = PositionWiseConvFF(hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(self.attn_norm(self.mha(x) + x))


class StyleEncoderAttn(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, out_size: int):
        super().__init__()
        self.conv0 = nn.Conv1d(input_size, hidden_size, 3, padding=1)
        self.ln0 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.conv1 = nn.Conv1d(hidden_size, out_size, 3, padding=1)
        self.ln1 = nn.LayerNorm(out_size, eps=1e-5)
        self.block0 = FFTBlock(out_size)
        self.out_size = out_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln0(F.relu(_conv_same(x, self.conv0)))
        h = self.ln1(F.relu(_conv_same(h, self.conv1)))
        T = h.shape[1]
        pos = torch.as_tensor(sinusoidal_pe(max(T, 64), self.out_size)[:T], device=h.device)
        return self.block0(h + pos[None]).mean(dim=1)


class StyleEncoderVAE(nn.Module):
    """StyleEncoder(use_vae=True): the inner encoder is 'gru' or 'attn'."""

    def __init__(self, input_size: int, hidden_size: int, style_embedding_size: int,
                 encoder_type: str = "gru"):
        super().__init__()
        encoders = {"gru": StyleEncoderGRU, "attn": StyleEncoderAttn}
        if encoder_type not in encoders:
            raise ValueError(f"unknown style encoder type {encoder_type!r}")
        self.encoder = encoders[encoder_type](input_size, hidden_size, 2 * style_embedding_size)
        self.style_embedding_size = style_embedding_size

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                temperature: float = 1.0, eps: Optional[torch.Tensor] = None):
        """→ (z, mu, logvar). z = mu + eps · exp(logvar / 2) / temperature, eps
        drawn from `generator` (or given); with neither, z = mu."""
        enc = self.encoder(x)
        mu, logvar = enc[:, : self.style_embedding_size], enc[:, self.style_embedding_size:]
        if generator is None and eps is None:
            return mu, mu, logvar
        std = torch.exp(0.5 * logvar) / temperature
        if eps is None:
            eps = torch.randn(std.shape, generator=generator, device=std.device)
        return mu + eps * std, mu, logvar


class CellStateEncoder(nn.Module):
    def __init__(self, pose_size: int, style_size: int, hidden_size: int, num_rnn_layers: int):
        super().__init__()
        self.layer0 = nn.Linear(pose_size + style_size, hidden_size)
        self.layer1 = nn.Linear(hidden_size, hidden_size)
        self.layer2 = nn.Linear(hidden_size, hidden_size * num_rnn_layers)
        self.num_rnn_layers = num_rnn_layers

    def forward(self, pose: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """→ (num_rnn_layers, B, hidden) initial GRU states."""
        h = F.elu(self.layer0(torch.cat([pose, style], -1)))
        out = self.layer2(F.elu(self.layer1(h)))
        return out.reshape(pose.shape[0], self.num_rnn_layers, -1).transpose(0, 1)


class RecurrentDecoderNormal(nn.Module):
    def __init__(self, pose_size: int, speech_size: int, style_size: int, hidden_size: int,
                 output_size: int, num_rnn_layers: int):
        super().__init__()
        cat = pose_size + speech_size + style_size
        self.layer0 = nn.Linear(cat, hidden_size)
        self.gru = nn.ModuleList(
            nn.GRUCell(hidden_size + cat if layer == 0 else hidden_size, hidden_size)
            for layer in range(num_rnn_layers))
        self.layer2 = nn.Linear(hidden_size, output_size)

    def forward(self, pose, speech, style, cell_state):
        """One frame → (output, (num_rnn_layers, B, hidden) new states)."""
        cat = torch.cat([pose, speech, style], dim=-1)
        x = torch.cat([F.elu(self.layer0(cat)), cat], dim=-1)
        states = []
        for layer, cell in enumerate(self.gru):
            x = cell(x, cell_state[layer])
            states.append(x)
        return self.layer2(x), torch.stack(states)


def vectorize_input(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt, gaze_pos,
                    anim_input_mean, anim_input_std):
    """(parity: `modules.py:666-701`)."""
    B = lpos.shape[0]
    gaze_dir = quat.mul_vec(quat.inv(root_rot), gaze_pos - root_pos)
    enc = torch.cat([root_vel.reshape(B, -1), root_vrt.reshape(B, -1), lpos.reshape(B, -1),
                     ltxy.reshape(B, -1), lvel.reshape(B, -1), lvrt.reshape(B, -1),
                     gaze_dir.reshape(B, -1)], dim=1)
    return (enc - anim_input_mean) / anim_input_std


def devectorize_output(predicted, root_pos, root_rot, njoints: int, dt: float, anim_output_mean,
                       anim_output_std):
    """(parity: `modules.py:704-730`)."""
    B = predicted.shape[0]
    p = predicted * anim_output_std + anim_output_mean
    root_vel, root_vrt = p[:, 0:3], p[:, 3:6]
    lpos = p[:, 6: 6 + njoints * 3].reshape(B, njoints, 3)
    ltxy = p[:, 6 + njoints * 3: 6 + njoints * 9].reshape(B, njoints, 2, 3)
    lvel = p[:, 6 + njoints * 9: 6 + njoints * 12].reshape(B, njoints, 3)
    lvrt = p[:, 6 + njoints * 12: 6 + njoints * 15].reshape(B, njoints, 3)
    new_root_pos = quat.mul_vec(root_rot, root_vel * dt) + root_pos
    new_root_rot = quat.mul(quat.from_helical(quat.mul_vec(root_rot, root_vrt * dt)), root_rot)
    return new_root_pos, new_root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt


@dataclasses.dataclass(frozen=True)
class ZeroEGGSConfig:
    njoints: int = 75
    pose_input_size: int = 75 * 15 + 9  # vectorized pose + root vel/vrt + gaze
    pose_output_size: int = 75 * 15 + 6
    speech_encoding_size: int = 128
    style_embedding_size: int = 64
    hidden_size: int = 512
    num_rnn_layers: int = 2
    dt: float = 1.0 / 60.0
    style_encoder_type: str = "gru"  # 'gru' | 'attn' (ref StyleEncoder type)


STAT_KEYS = ("anim_input_mean", "anim_input_std", "anim_output_mean", "anim_output_std")


class ZeroEGGSDecoder(nn.Module):
    """Autoregressive decoder rollout (`Decoder.forward`, `modules.py:49-150`)."""

    def __init__(self, cfg: ZeroEGGSConfig):
        super().__init__()
        self.cfg = cfg
        self.cell_state_encoder = CellStateEncoder(
            cfg.pose_input_size, cfg.style_embedding_size, cfg.hidden_size, cfg.num_rnn_layers)
        self.recurrent_decoder = RecurrentDecoderNormal(
            cfg.pose_input_size, cfg.speech_encoding_size, cfg.style_embedding_size,
            cfg.hidden_size, cfg.pose_output_size, cfg.num_rnn_layers)

    def initial_carry(self, initial_state: Sequence[torch.Tensor], gaze0: torch.Tensor,
                      style0: torch.Tensor, stats: Dict[str, torch.Tensor]) -> Tuple:
        """(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt) at
        frame 0 + the cell states the cell-state encoder makes from them."""
        pose0 = vectorize_input(*initial_state, gaze0, stats["anim_input_mean"],
                                stats["anim_input_std"])
        return tuple(initial_state) + (self.cell_state_encoder(pose0, style0),)

    def step(self, carry: Tuple, speech_i: torch.Tensor, style_i: torch.Tensor,
             gaze_i: torch.Tensor, stats: Dict[str, torch.Tensor]) -> Tuple:
        """One frame of the rollout: the carry of frame i−1 → that of frame i."""
        rp, rr, rv, rt, lp, lt, lv, lr, cell = carry
        pose = vectorize_input(rp, rr, rv, rt, lp, lt, lv, lr, gaze_i, stats["anim_input_mean"],
                               stats["anim_input_std"])
        pred, cell = self.recurrent_decoder(pose, speech_i, style_i, cell)
        out = devectorize_output(pred, rp, rr, self.cfg.njoints, self.cfg.dt,
                                 stats["anim_output_mean"], stats["anim_output_std"])
        return out + (cell,)

    def forward(self, initial_state: Sequence[torch.Tensor], gaze_pos: torch.Tensor,
                speech_encoding: torch.Tensor, style_encoding: torch.Tensor,
                stats: Dict[str, torch.Tensor]):
        """initial_state: frame-0 tensors (B, …); gaze (B, T, 3), speech (B, T, S),
        style (B, T, E); stats: the anim input / output means and stds. →
        (root_pos (B, T, 3), root_rot (B, T, 4), lpos (B, T, J, 3),
        ltxy (B, T, J, 2, 3)), frame 0 the given one (the reference keeps it)."""
        carry = self.initial_carry(initial_state, gaze_pos[:, 0], style_encoding[:, 0], stats)
        frames = [(carry[0], carry[1], carry[4], carry[5])]
        for i in range(1, speech_encoding.shape[1]):
            carry = self.step(carry, speech_encoding[:, i], style_encoding[:, i], gaze_pos[:, i],
                              stats)
            frames.append((carry[0], carry[1], carry[4], carry[5]))
        return tuple(torch.stack(seq, dim=1) for seq in zip(*frames))


class ZeroEGGS(nn.Module):
    """The three networks trained together: `speech`, `style` and `decoder`."""

    def __init__(self, cfg: ZeroEGGSConfig, audio_dim: int):
        super().__init__()
        self.cfg = cfg
        self.speech = SpeechEncoder(audio_dim, cfg.hidden_size, cfg.speech_encoding_size)
        self.style = StyleEncoderVAE(cfg.pose_input_size, cfg.hidden_size,
                                     cfg.style_embedding_size, cfg.style_encoder_type)
        self.decoder = ZeroEGGSDecoder(cfg)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """(parity: `compute_KL_div` core, `modules.py:766-767`)."""
    kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
    return torch.mean(kl)


def kl_weight(iteration, center: float = 7500.0, growth: float = 0.005,
              threshold: float = 0.2) -> torch.Tensor:
    """KL annealing weight (`modules.py:733-777`), float32."""
    it = torch.as_tensor(iteration, dtype=torch.float32)
    return torch.clamp(1.0 / (1.0 + torch.exp(-growth * (it - center))), max=threshold)


class RAdam:
    """`optax.radam(lr, b1, b2, eps, eps_root=0, threshold=5)` over a `FlatParams`.

    Per step, in optax's order: mu, nu ← moments of g; k = count + 1;
    mu_hat = mu / (1 − b1^k), nu_hat = nu / (1 − b2^k); ro = ro_inf −
    2k·b2^k / (1 − b2^k) with ro_inf = 2/(1 − b2) − 1; the update is
    r · mu_hat / (sqrt(nu_hat) + eps) with r = sqrt((ro−4)(ro−2)ro_inf /
    ((ro_inf−4)(ro_inf−2)ro)) where ro ≥ threshold, else mu_hat; p −= lr ·
    update. torch.optim.RAdam differs: it adds eps to sqrt(nu) before nu's
    bias correction (optax adds it to sqrt(nu_hat)) and rectifies where
    ro > 5 (optax: ro ≥ threshold).
    """

    def __init__(self, params: FlatParams, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, threshold: float = 5.0):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.threshold = threshold
        self.mu = torch.zeros_like(params.data)
        self.nu = torch.zeros_like(params.data)
        self.count = torch.zeros((), dtype=torch.int32, device=params.data.device)

    @torch.no_grad()
    def step(self) -> None:
        g, b1, b2 = self.params.grad, self.b1, self.b2
        self.mu.copy_((1 - b1) * g + b1 * self.mu)
        self.nu.copy_((1 - b2) * (g * g) + b2 * self.nu)
        self.count.add_(1)
        k = self.count.float()
        b2t = b2 ** k
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * k * b2t / (1 - b2t)
        mu_hat = self.mu / (1 - b1 ** k)
        nu_hat = self.nu / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        update = torch.where(ro >= self.threshold, r * mu_hat / (torch.sqrt(nu_hat) + self.eps),
                             mu_hat)
        self.params.data.add_(-self.lr * update)


class ZeroEggsTrainStep:
    """The train step of the JAX `make_zeroeggs_train_step`
    (`ZEGGS/train.py:30-770`'s core): the speech encoding of the normalized
    audio features, a style code sampled from the VAE on the style example,
    the decoder's rollout from the window's first frame, the L1
    reconstruction of root position / rotation and local positions /
    transforms, plus the annealed KL; one optax-exact RAdam update over the
    three networks' parameters, held as one flat buffer.

    `step(batch, generator, iteration, eps=None)` → {'loss', 'rec', 'kl',
    'kl_weight'} as device tensors; `batch` holds `initial_state` (8
    tensors), `gaze`, `audio_features`, `style_example` and the
    `target_root_pos/rot`, `target_lpos`, `target_ltxy`; `eps` replaces the
    VAE's draw.
    """

    def __init__(self, model: ZeroEGGS, stats: Dict[str, torch.Tensor], lr: float = 1e-4):
        self.model, self.stats = model, stats
        self.params = FlatParams(model)
        self.opt = RAdam(self.params, lr)

    def loss(self, batch: Dict, generator: Optional[torch.Generator], iteration,
             eps: Optional[torch.Tensor] = None):
        m, st = self.model, self.stats
        af = (batch["audio_features"] - st["audio_input_mean"]) / st["audio_input_std"]
        speech = m.speech(af)
        z, mu, logvar = m.style(batch["style_example"], generator, eps=eps)
        style_seq = z[:, None, :].expand(z.shape[0], speech.shape[1], z.shape[1])
        rp, rr, lp, lt = m.decoder(batch["initial_state"], batch["gaze"], speech, style_seq, st)
        rec = (torch.mean(torch.abs(rp - batch["target_root_pos"]))
               + torch.mean(torch.abs(rr - batch["target_root_rot"]))
               + torch.mean(torch.abs(lp - batch["target_lpos"]))
               + torch.mean(torch.abs(lt - batch["target_ltxy"])))
        kl = kl_divergence(mu, logvar)
        w = kl_weight(iteration).to(rec.device)
        return rec + w * kl, {"rec": rec, "kl": kl, "kl_weight": w}

    def step(self, batch: Dict, generator: Optional[torch.Generator], iteration,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        self.params.grad.zero_()
        loss, aux = self.loss(batch, generator, iteration, eps)
        loss.backward()
        self.opt.step()
        aux["loss"] = loss.detach()
        return {k: v.detach() for k, v in aux.items()}


def stats_to_device(stats: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The stats.npz arrays as float32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in stats.items()}
