"""Timestep samplers: uniform, and importance sampling on the loss's second moment.

Port of `diffusestylegesture_tpu/diffusion/resample.py` (reference
`main/diffusion/resample.py:8-154`). The loss-aware history lives in device
tensors and is updated without a host sync: the reference's sequential
per-example ring insertion becomes one gather and one scatter that give the
same rows. The JAX `axis_name` all-gather across a mesh waits for the
port's multi-card slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def uniform_sample_t(generator: Optional[torch.Generator], batch: int, num_timesteps: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """UniformSampler (ref `:42-58`): t ~ U{0..T-1}, weights 1."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones(batch, device=device)


@dataclasses.dataclass
class LossAwareState:
    """Per-timestep history of the last `history_per_term` losses (ref `:124-154`)."""

    history: torch.Tensor  # (T, history_per_term) float32
    counts: torch.Tensor  # (T,) int64: losses recorded so far, at most history_per_term

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10,
               device=None) -> "LossAwareState":
        return cls(history=torch.zeros(num_timesteps, history_per_term, device=device),
                   counts=torch.zeros(num_timesteps, dtype=torch.long, device=device))


def loss_aware_weights(state: LossAwareState, uniform_prob: float = 0.001) -> torch.Tensor:
    """Sampling distribution over t (`LossSecondMomentResampler.weights:137-144`):
    uniform until every timestep's history is full."""
    T = state.history.shape[0]
    warmed = torch.all(state.counts == state.history.shape[1])
    w = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
    w = w / torch.sum(w)
    w = w * (1 - uniform_prob) + uniform_prob / T
    return torch.where(warmed, w, torch.full_like(w, 1.0 / T))


def loss_aware_sample_t(generator: Optional[torch.Generator], state: LossAwareState,
                        batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample t; weights 1/(T·p_t) (ref `:42-58`)."""
    p = loss_aware_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def update_with_losses(state: LossAwareState, ts: torch.Tensor,
                       losses: torch.Tensor) -> LossAwareState:
    """Append each finite (t, loss) pair, in batch order, to its timestep's
    ring (ref `:145-153`): a non-finite loss never enters the history.

    The reference inserts one pair at a time. Per timestep that appends its
    new losses to the c recorded ones and keeps the last `hpt`; so each new
    loss lands at (c + its rank among the batch's finite losses of that
    timestep − shift), shift = max(0, c + n − hpt), and the kept old entries
    move left by shift.
    """
    hist, counts = state.history, state.counts
    T, hpt = hist.shape
    ts = ts.long()
    losses = losses.detach().float()
    finite = torch.isfinite(losses)
    B = ts.shape[0]
    same = (ts[:, None] == ts[None, :]) & finite[None, :]
    earlier = torch.ones(B, B, dtype=torch.bool, device=ts.device).tril(-1)
    rank = (same & earlier).sum(dim=1)
    n_new = torch.zeros(T, dtype=torch.long, device=ts.device).scatter_add_(0, ts, finite.long())
    shift = (counts + n_new - hpt).clamp(min=0)

    cols = torch.arange(hpt, device=hist.device)[None, :] + shift[:, None]
    kept = cols < counts[:, None]
    new_hist = torch.where(kept, hist.gather(1, cols.clamp(max=hpt - 1)), 0.0)
    pos = counts[ts] + rank - shift[ts]
    # pairs that do not land (non-finite, or pushed out by later ones) go to a spare column
    land = finite & (pos >= 0)
    pos = torch.where(land, pos, hpt)
    padded = torch.cat([new_hist, torch.zeros(T, 1, device=hist.device)], dim=1)
    padded.index_put_((ts, pos), torch.where(land, losses, 0.0))
    return LossAwareState(history=padded[:, :hpt].contiguous(),
                          counts=(counts + n_new).clamp(max=hpt))
