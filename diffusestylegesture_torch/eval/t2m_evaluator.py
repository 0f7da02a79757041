"""Text-to-motion evaluator networks and the evaluation harness.

Port of `diffusestylegesture_tpu/eval/t2m_evaluator.py` (the reference's
humanml evaluation stack, `main/eval/eval_humanml.py`):

  * `MovementConvEncoder` / `TextEncoderBiGRUCo` / `MotionEncoderBiGRUCo`
    (`main/data_loaders/humanml/networks/modules.py:79-387`) with the
    reference's module names, so the `finest.tar` state dicts
    (`movement_encoder`, `text_encoder`, `motion_encoder`) load as they are.
    The GRUs run `nn.GRU` over `pack_padded_sequence(enforce_sorted=False)`:
    each sequence stops at its own length, which gives the JAX masked scan's
    final states, in input order.
  * `T2MEvaluator`, the `EvaluatorMDMWrapper` analog
    (`evaluator_wrapper.py:121-186`): co-embeddings of text / motion pairs
    and motion embeddings, returned in *input* order as the JAX package
    returns them (the reference sorts by descending length).
  * `evaluate_*` / `evaluation`: the metric harness of
    `eval/eval_humanml.py:19-138` (matching score, R-precision, FID,
    diversity, multimodality, mean / 95% CI over replications), numpy.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from ..device import resolve_device
from .metrics import frechet_distance
from .t2m import euclidean_distance_matrix, top_k_hits

POS_DIM = 15  # len(POS_enumerator)
UNIT_LENGTH = 4


class MovementConvEncoder(nn.Module):
    """Two stride-2 convs (k 4, pad 1) + a linear head (modules.py:79-99); the
    dropouts are inference no-ops."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Dropout(0.2), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(x.permute(0, 2, 1)).permute(0, 2, 1))


def _head(hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * hidden, hidden), nn.LayerNorm(hidden),
                         nn.LeakyReLU(0.2), nn.Linear(hidden, out))


def _bigru_last(gru: nn.GRU, x: torch.Tensor, lengths: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """Final forward and backward states of a bidirectional GRU that stops at
    each row's length, (B, 2H) in input order."""
    packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64), batch_first=True,
                                  enforce_sorted=False)
    _, h = gru(packed, h0.contiguous())
    return torch.cat([h[0], h[1]], dim=-1)


class TextEncoderBiGRUCo(nn.Module):
    """(word embeddings, POS one-hots, lengths) -> co-embedding (modules.py:311-349)."""

    def __init__(self, word_size: int = 300, pos_size: int = POS_DIM, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.output_net = _head(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        inputs = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        h0 = self.hidden.expand(2, word_embs.shape[0], -1)
        return self.output_net(_bigru_last(self.gru, inputs, cap_lens, h0))


class MotionEncoderBiGRUCo(nn.Module):
    """(movement features, lengths) -> co-embedding (modules.py:353-387)."""

    def __init__(self, input_size: int = 512, hidden_size: int = 1024, output_size: int = 512):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.output_net = _head(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def forward(self, inputs, m_lens):
        x = self.input_emb(inputs)
        h0 = self.hidden.expand(2, inputs.shape[0], -1)
        return self.output_net(_bigru_last(self.gru, x, m_lens, h0))


# ---- the JAX package's params -> the reference's state dicts (tests, conversion) --

def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _f32(p["bias"])


def _bigru_co(p: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    if "pos_emb" in p:
        _dense(sd, "pos_emb", p["pos_emb"])
    _dense(sd, "input_emb", p["input_emb"])
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for gate in ("ih", "hh"):
            cell = p["gru"][direction][gate]
            sd[f"gru.weight_{gate}_l0{suffix}"] = _f32(np.asarray(cell["kernel"]).T)
            sd[f"gru.bias_{gate}_l0{suffix}"] = _f32(cell["bias"])
    sd["hidden"] = _f32(p["hidden"])
    head = p["output_net"]
    _dense(sd, "output_net.0", head["dense0"])
    sd["output_net.1.weight"] = _f32(head["norm"]["scale"])
    sd["output_net.1.bias"] = _f32(head["norm"]["bias"])
    _dense(sd, "output_net.3", head["dense1"])
    return sd


def evaluator_state_dicts_from_flax(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX `T2MEvaluator` params ({'movement', 'text', 'motion'}) -> the
    `finest.tar` layout ({'movement_encoder', 'text_encoder', 'motion_encoder'})."""
    mv = params["movement"]
    movement: Dict[str, torch.Tensor] = {}
    for name, idx in (("conv0", 0), ("conv1", 3)):
        movement[f"main.{idx}.weight"] = _f32(np.asarray(mv[name]["kernel"]).transpose(2, 1, 0))
        movement[f"main.{idx}.bias"] = _f32(mv[name]["bias"])
    _dense(movement, "out_net", mv["out_net"])
    return {"movement_encoder": movement, "text_encoder": _bigru_co(params["text"]),
            "motion_encoder": _bigru_co(params["motion"])}


# ---- wrapper ------------------------------------------------------------------------

class T2MEvaluator:
    """EvaluatorMDMWrapper analog (evaluator_wrapper.py:121-186).

    checkpoint: the `finest.tar` dict (or any mapping with its three state
    dicts); dataset 'humanml' (dim_pose 263) or 'kit' (251). Embeddings come
    back as float32 numpy arrays in input order."""

    def __init__(self, checkpoint: Mapping, dataset: str = "humanml",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.dim_pose = 263 if dataset == "humanml" else 251
        self.movement = MovementConvEncoder(self.dim_pose - 4, 512, 512)
        self.text = TextEncoderBiGRUCo()
        self.motion = MotionEncoderBiGRUCo()
        for module, key in ((self.movement, "movement_encoder"), (self.text, "text_encoder"),
                            (self.motion, "motion_encoder")):
            module.load_state_dict(checkpoint[key])
            module.to(self.device).eval().requires_grad_(False)

    @staticmethod
    def seeded_checkpoint(seed: int = 0, dataset: str = "humanml") -> Dict[str, Dict]:
        """State dicts of the three networks at the published widths, initialised
        from `seed` (torch's default inits): a stand-in for `finest.tar`."""
        dim_pose = 263 if dataset == "humanml" else 251
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return {"movement_encoder": MovementConvEncoder(dim_pose - 4, 512, 512).state_dict(),
                    "text_encoder": TextEncoderBiGRUCo().state_dict(),
                    "motion_encoder": MotionEncoderBiGRUCo().state_dict()}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        with torch.no_grad():
            movements = self.movement(self._t(motions)[..., :-4])
            lens = torch.as_tensor(np.asarray(m_lens)) // UNIT_LENGTH
            return self.motion(movements, lens).float().cpu().numpy()

    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        with torch.no_grad():
            text = self.text(self._t(word_embs), self._t(pos_ohot),
                             torch.as_tensor(np.asarray(cap_lens)))
        return text.float().cpu().numpy(), self.get_motion_embeddings(motions, m_lens)


# ---- metric harness (eval_humanml.py:19-138) -------------------------------------

def evaluate_matching_score(eval_wrapper: T2MEvaluator, motion_loaders: Dict[str, Iterable]):
    """Each loader yields dicts with word_embs / pos_ohot / cap_lens / motions /
    m_lens. Returns (matching score, R-precision, activations) per loader."""
    match_scores, r_precisions, activations = OrderedDict(), OrderedDict(), OrderedDict()
    for name, loader in motion_loaders.items():
        all_emb, match_sum, top_k_count, size = [], 0.0, np.zeros(3), 0
        for batch in loader:
            text_emb, motion_emb = eval_wrapper.get_co_embeddings(
                batch["word_embs"], batch["pos_ohot"], batch["cap_lens"],
                batch["motions"], batch["m_lens"])
            dist = euclidean_distance_matrix(text_emb, motion_emb)
            match_sum += dist.trace()
            top_k_count = top_k_count + top_k_hits(np.argsort(dist, axis=1), 3).sum(axis=0)
            size += text_emb.shape[0]
            all_emb.append(motion_emb)
        match_scores[name] = match_sum / size
        r_precisions[name] = top_k_count / size
        activations[name] = np.concatenate(all_emb, axis=0)
    return match_scores, r_precisions, activations


def evaluate_fid(eval_wrapper: T2MEvaluator, gt_loader: Iterable,
                 activations: Dict[str, np.ndarray]):
    gt_emb = np.concatenate([eval_wrapper.get_motion_embeddings(b["motions"], b["m_lens"])
                             for b in gt_loader], axis=0)
    return OrderedDict((name, frechet_distance(gt_emb, emb)) for name, emb in activations.items())


def evaluate_diversity(activations: Dict[str, np.ndarray], diversity_times: int, seed: int = 0):
    out = OrderedDict()
    rng = np.random.default_rng(seed)
    for name, emb in activations.items():
        first = rng.choice(len(emb), diversity_times, replace=False)
        second = rng.choice(len(emb), diversity_times, replace=False)
        out[name] = float(np.linalg.norm(emb[first] - emb[second], axis=1).mean())
    return out


def evaluate_multimodality(eval_wrapper: T2MEvaluator, mm_loaders: Dict[str, Iterable],
                           mm_num_times: int, seed: int = 0):
    out = OrderedDict()
    rng = np.random.default_rng(seed)
    for name, loader in mm_loaders.items():
        embs = [eval_wrapper.get_motion_embeddings(b["motions"], b["m_lens"])[None]
                for b in loader]
        if not embs:
            out[name] = 0.0
            continue
        emb = np.concatenate(embs, axis=0)  # (n_prompts, reps, D)
        first = rng.choice(emb.shape[1], mm_num_times, replace=False)
        second = rng.choice(emb.shape[1], mm_num_times, replace=False)
        out[name] = float(np.linalg.norm(emb[:, first] - emb[:, second], axis=2).mean())
    return out


def get_metric_statistics(values: np.ndarray, replication_times: int):
    return np.mean(values, axis=0), 1.96 * np.std(values, axis=0) / math.sqrt(replication_times)


def evaluation(eval_wrapper: T2MEvaluator, gt_loader_fn: Callable[[], Iterable],
               eval_loader_fns: Dict[str, Callable[[], Iterable]], replication_times: int = 1,
               diversity_times: int = 300, mm_num_times: int = 10,
               mm_loader_fns: Optional[Dict[str, Callable[[], Iterable]]] = None):
    """The reference's `evaluation` loop (eval_humanml.py:122-201) over loader
    factories; returns {metric: {model: (mean, 95% CI)}}."""
    all_metrics: Dict[str, Dict[str, list]] = {
        "Matching Score": {}, "R_precision": {}, "FID": {}, "Diversity": {},
        "MultiModality": {}}
    for rep in range(replication_times):
        loaders = {name: fn() for name, fn in eval_loader_fns.items()}
        loaders["ground truth"] = gt_loader_fn()
        match, rprec, acts = evaluate_matching_score(eval_wrapper, loaders)
        fids = evaluate_fid(eval_wrapper, gt_loader_fn(), acts)
        divs = evaluate_diversity(acts, diversity_times, seed=rep)
        mms = (evaluate_multimodality(eval_wrapper, {n: fn() for n, fn in mm_loader_fns.items()},
                                      mm_num_times, seed=rep) if mm_loader_fns else {})
        for metric, values in (("Matching Score", match), ("R_precision", rprec), ("FID", fids),
                               ("Diversity", divs), ("MultiModality", mms)):
            for name, v in values.items():
                all_metrics[metric].setdefault(name, []).append(v)
    return {metric: {name: get_metric_statistics(np.stack(vals), replication_times)
                     for name, vals in models.items()}
            for metric, models in all_metrics.items()}
