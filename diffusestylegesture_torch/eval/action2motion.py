"""The action2motion GRU motion classifier and the unconstrained eval harness.

Port of `diffusestylegesture_tpu/eval/action2motion.py`
(`main/eval/a2m/action2motion/models.py`, the metric wiring of
`main/eval/unconstrained/evaluate.py:57-150`):

  * `MotionDiscriminator`: a 2-layer GRU over the flattened joints, the last
    *valid* step of each sequence -> tanh(Linear 30) -> Linear logits;
    `for_fid=True` returns the 30-d tanh features instead
    (`MotionDiscriminatorForFID`, models.py:45-62). Module names are the
    reference's (`recurrent`, `linear1`, `linear2`), so `humanact12_gru.tar`
    loads as it is. The reference draws a random initial state at each call
    (`initHidden`, models.py:41); here h0 is zeros unless given, as in the
    JAX package.
  * `unconstrained_metrics`: FID + KID + precision / recall + diversity over
    classifier features (`evaluate_unconstrained_metrics`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .metrics import diversity as _diversity, frechet_distance
from .unconstrained import kid, precision_and_recall


class MotionDiscriminator(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 128, hidden_layers: int = 2,
                 output_size: int = 12, for_fid: bool = False):
        super().__init__()
        self.hidden_size, self.hidden_layers, self.for_fid = hidden_size, hidden_layers, for_fid
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layers)
        self.linear1 = nn.Linear(hidden_size, 30)
        if not for_fid:
            self.linear2 = nn.Linear(30, output_size)

    def forward(self, motion: torch.Tensor, lengths: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """motion (B, J, F, T), lengths (B,) -> logits (B, output), or the
        30-d features with `for_fid`."""
        b, nj, nf, t = motion.shape
        x = motion.reshape(b, nj * nf, t).permute(2, 0, 1)  # (T, B, D)
        if h0 is None:
            h0 = x.new_zeros(self.hidden_layers, b, self.hidden_size)
        out, _ = self.recurrent(x, h0)
        last = out[lengths.to(out.device).long() - 1, torch.arange(b, device=out.device)]
        lin1 = torch.tanh(self.linear1(last))
        return lin1 if self.for_fid else self.linear2(lin1)


def motion_discriminator_state_dict_from_flax(params: Mapping, hidden_layers: int = 2
                                              ) -> Dict[str, torch.Tensor]:
    """The JAX `MotionDiscriminator` params -> the reference torch state dict
    (the inverse of the JAX `convert_motion_discriminator`)."""
    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for layer in range(hidden_layers):
        for gate in ("ih", "hh"):
            cell = params[f"gru_l{layer}"][gate]
            sd[f"recurrent.weight_{gate}_l{layer}"] = f32(np.asarray(cell["kernel"]).T)
            sd[f"recurrent.bias_{gate}_l{layer}"] = f32(cell["bias"])
    for name in ("linear1", "linear2"):
        if name in params:
            sd[f"{name}.weight"] = f32(np.asarray(params[name]["kernel"]).T)
            sd[f"{name}.bias"] = f32(params[name]["bias"])
    return sd


def unconstrained_metrics(gt_features: np.ndarray, gen_features: np.ndarray,
                          diversity_times: int = 300, kid_subsets: int = 100,
                          seed: int = 0) -> dict:
    """FID / KID / precision-recall / diversity over classifier features
    (evaluate_unconstrained_metrics, unconstrained/evaluate.py:57-150)."""
    fid = frechet_distance(gt_features, gen_features)
    kid_mean, kid_std = kid(gt_features, gen_features, n_subsets=kid_subsets, seed=seed)
    precision, recall = precision_and_recall(gen_features, gt_features)
    return {"fid": fid, "kid_mean": kid_mean, "kid_std": kid_std, "precision": precision,
            "recall": recall,
            "diversity_gt": _diversity(gt_features, min(diversity_times, len(gt_features)), seed),
            "diversity_gen": _diversity(gen_features, min(diversity_times, len(gen_features)),
                                        seed)}
