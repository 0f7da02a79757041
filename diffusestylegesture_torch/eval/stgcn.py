"""Action-to-motion (a2m) evaluation: the ST-GCN action recognizer and its metrics.

Port of `diffusestylegesture_tpu/eval/stgcn.py` (the reference's MDM-legacy
a2m suite):

  * `Graph`: skeleton adjacency with the uniform / distance / spatial
    partitions (`main/eval/a2m/recognition/models/stgcnutils/graph.py`);
    the smpl layouts take the parent table directly (numpy, as the JAX
    package's).
  * `STGCN`: the 10-block spatial-temporal graph convnet
    (`.../models/stgcn.py:11-131`) with the reference's module names, so the
    released `uestc_rot6d_stgcn.tar` state dict loads as it is, and learnable
    edge-importance masks. It runs NCHW ((N, C, T, V)) inside and takes and
    returns the JAX layout: motion (N, V, C, T) -> (features (N, 256),
    logits (N, num_class)). Inference only (BatchNorm running statistics).
  * `calculate_accuracy`, `calculate_diversity_multimodality` (the same
    MT19937 draw sequence as the reference, `stgcn/diversity.py`), FID
    through `eval/metrics.py`, and `A2MEvaluation` (`stgcn/evaluate.py:10-108`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .metrics import frechet_distance

# SMPL kinematic-tree parents (kintree_table row 0) — the constant the
# reference deserializes from `smpl_kintree_path` (graph.py:56-71).
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
                12, 13, 14, 16, 17, 18, 19, 20, 21]


def get_hop_distance(num_node: int, edge, max_hop: int = 1) -> np.ndarray:
    a = np.zeros((num_node, num_node))
    for i, j in edge:
        a[j, i] = 1
        a[i, j] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer = np.stack([np.linalg.matrix_power(a, d) for d in range(max_hop + 1)]) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[transfer[d]] = d
    return hop_dis


def normalize_digraph(a: np.ndarray) -> np.ndarray:
    degree = a.sum(axis=0)
    dn = np.where(degree > 0, 1.0 / np.where(degree > 0, degree, 1.0), 0.0)
    return a @ np.diag(dn)


def normalize_undigraph(a: np.ndarray) -> np.ndarray:
    degree = a.sum(axis=0)
    dn = np.where(degree > 0, degree ** -0.5, 0.0)
    return np.diag(dn) @ a @ np.diag(dn)


class Graph:
    """Skeleton graph + partitioned adjacency stack A (K, V, V)."""

    def __init__(self, layout: str = "openpose", strategy: str = "uniform",
                 max_hop: int = 1, dilation: int = 1,
                 parents: Optional[Sequence[int]] = None):
        self.max_hop = max_hop
        self.dilation = dilation
        self._get_edge(layout, parents)
        self.hop_dis = get_hop_distance(self.num_node, self.edge, max_hop)
        self._get_adjacency(strategy)

    def _get_edge(self, layout: str, parents) -> None:
        if layout == "openpose":
            self.num_node = 18
            neighbor = [(4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
                        (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1),
                        (0, 1), (15, 0), (14, 0), (17, 15), (16, 14)]
            self.center = 1
        elif layout == "openpose15":
            # the unconstrained-eval graph redefines 'openpose' as this
            # 15-joint MoDi skeleton (eval/unconstrained/models/
            # stgcnutils/graph.py:47-60)
            self.num_node = 15
            neighbor = [(4, 3), (3, 2), (2, 1), (7, 6), (6, 5), (5, 1),
                        (1, 0), (14, 13), (13, 12), (12, 8), (11, 10),
                        (10, 9), (9, 8), (8, 1)]
            self.center = 1
        elif layout in ("smpl", "smpl_noglobal"):
            par = list(parents) if parents is not None else SMPL_PARENTS
            neighbor = [(par[j], j) for j in range(1, len(par))]
            if layout == "smpl_noglobal":
                neighbor = [(i - 1, j - 1) for i, j in neighbor if i != 0 and j != 0]
                self.num_node = len(par) - 1
            else:
                self.num_node = len(par)
            self.center = 0
        elif layout == "ntu-rgb+d":
            self.num_node = 25
            base = [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
                    (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
                    (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
                    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12)]
            neighbor = [(i - 1, j - 1) for i, j in base]
            self.center = 20
        else:
            raise NotImplementedError(f"layout {layout!r} not supported")
        self.edge = [(i, i) for i in range(self.num_node)] + neighbor

    def _get_adjacency(self, strategy: str) -> None:
        valid_hop = range(0, self.max_hop + 1, self.dilation)
        adjacency = np.zeros((self.num_node, self.num_node))
        for hop in valid_hop:
            adjacency[self.hop_dis == hop] = 1
        norm = normalize_digraph(adjacency)

        if strategy == "uniform":
            self.A = norm[None]
        elif strategy == "distance":
            a = np.zeros((len(valid_hop), self.num_node, self.num_node))
            for i, hop in enumerate(valid_hop):
                a[i][self.hop_dis == hop] = norm[self.hop_dis == hop]
            self.A = a
        elif strategy == "spatial":
            parts = []
            dc = self.hop_dis[:, self.center]
            for hop in valid_hop:
                on_hop = self.hop_dis == hop
                root = on_hop & (dc[:, None] == dc[None, :])
                close = on_hop & (dc[:, None] > dc[None, :])
                further = on_hop & (dc[:, None] < dc[None, :])
                if hop == 0:
                    parts.append(np.where(root, norm, 0.0))
                else:
                    parts.append(np.where(root | close, norm, 0.0))
                    parts.append(np.where(further, norm, 0.0))
            self.A = np.stack(parts)
        else:
            raise NotImplementedError(f"strategy {strategy!r} not supported")


# --- network ------------------------------------------------------------------------

class ConvTemporalGraphical(nn.Module):
    """tgcn.py:7-63: a 1 x 1 conv to K * C channels, then the K partitioned
    adjacencies."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = nn.Conv2d(in_channels, out_channels * kernel_size, 1)

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        n, kc, t, v = x.shape
        x = x.view(n, self.kernel_size, kc // self.kernel_size, t, v)
        return torch.einsum("nkctv,kvw->nctw", x, a).contiguous()


class STGCNBlock(nn.Module):
    """st_gcn (stgcn.py:133-207): graph conv -> BN / ReLU / temporal conv / BN /
    dropout (+ residual) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, temporal_kernel: int,
                 spatial_kernel: int, stride: int = 1, residual: bool = True):
        super().__init__()
        pad = (temporal_kernel - 1) // 2
        self.gcn = ConvTemporalGraphical(in_channels, out_channels, spatial_kernel)
        self.tcn = nn.Sequential(
            nn.BatchNorm2d(out_channels), nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, (temporal_kernel, 1), (stride, 1), (pad, 0)),
            nn.BatchNorm2d(out_channels), nn.Dropout(0.0, inplace=True))
        if not residual:
            self.residual = None
        elif in_channels == out_channels and stride == 1:
            self.residual = nn.Identity()
        else:
            self.residual = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, (stride, 1)), nn.BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        res = 0.0 if self.residual is None else self.residual(x)
        return torch.relu(self.tcn(self.gcn(x, a)) + res)


_CHANNELS = ((64, 1, False), (64, 1, True), (64, 1, True), (64, 1, True),
             (128, 2, True), (128, 1, True), (128, 1, True),
             (256, 2, True), (256, 1, True), (256, 1, True))

# the unconstrained-eval variant drops 3 blocks
# (main/eval/unconstrained/models/stgcn.py:52-63)
UNCONSTRAINED_CHANNELS = ((64, 1, False), (64, 1, True), (64, 1, True),
                          (128, 2, True), (128, 1, True), (256, 2, True))


class STGCN(nn.Module):
    """stgcn.py:11-131. forward(motion (N, V, C, T)) -> (features (N, 256),
    logits (N, num_class)); call `.eval()` (BatchNorm running statistics)."""

    def __init__(self, in_channels: int, num_class: int, graph: Graph,
                 edge_importance_weighting: bool = True, channels: tuple = _CHANNELS):
        super().__init__()
        self.register_buffer("A", torch.as_tensor(graph.A, dtype=torch.float32),
                             persistent=False)
        k, v, _ = graph.A.shape
        self.data_bn = nn.BatchNorm1d(in_channels * v)
        blocks, prev = [], in_channels
        for out, stride, residual in channels:
            blocks.append(STGCNBlock(prev, out, 9, k, stride, residual))
            prev = out
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = nn.ParameterList(
            nn.Parameter(torch.ones(k, v, v)) for _ in blocks) if edge_importance_weighting \
            else None
        self.fcn = nn.Conv2d(prev, num_class, 1)

    def forward(self, motion: torch.Tensor):
        n, v, c, t = motion.shape
        x = self.data_bn(motion.reshape(n, v * c, t)).reshape(n, v, c, t)
        x = x.permute(0, 2, 3, 1).contiguous()  # (N, C, T, V)
        for i, block in enumerate(self.st_gcn_networks):
            imp = 1.0 if self.edge_importance is None else self.edge_importance[i]
            x = block(x, self.A * imp)
        features = x.mean(dim=(2, 3))  # global average over (T, V)
        logits = self.fcn(features[:, :, None, None])[:, :, 0, 0]
        return features, logits


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def stgcn_state_dict_from_flax(variables: Mapping, channels: tuple = _CHANNELS
                               ) -> Dict[str, torch.Tensor]:
    """The JAX `STGCN` variables ({'params', 'batch_stats'}) -> the reference
    torch state dict (the inverse of the JAX `convert_stgcn_ckpt`)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix, node):
        sd[f"{prefix}.weight"] = _f32(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{prefix}.bias"] = _f32(node["bias"])

    def bn(prefix, node, stats):
        sd[f"{prefix}.weight"] = _f32(node["scale"])
        sd[f"{prefix}.bias"] = _f32(node["bias"])
        sd[f"{prefix}.running_mean"] = _f32(stats["mean"])
        sd[f"{prefix}.running_var"] = _f32(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    bn("data_bn", p["data_bn"], s["data_bn"])
    for i in range(len(channels)):
        bp, bs, pre = p[f"block{i}"], s[f"block{i}"], f"st_gcn_networks.{i}"
        conv(f"{pre}.gcn.conv", bp["gcn"]["conv"])
        bn(f"{pre}.tcn.0", bp["tcn_bn0"], bs["tcn_bn0"])
        conv(f"{pre}.tcn.2", bp["tcn_conv"])
        bn(f"{pre}.tcn.3", bp["tcn_bn1"], bs["tcn_bn1"])
        if "res_conv" in bp:
            conv(f"{pre}.residual.0", bp["res_conv"])
            bn(f"{pre}.residual.1", bp["res_bn"], bs["res_bn"])
        if f"edge_importance_{i}" in p:
            sd[f"edge_importance.{i}"] = _f32(p[f"edge_importance_{i}"])
    sd["fcn.weight"] = _f32(np.asarray(p["fcn"]["kernel"]).T[:, :, None, None])
    sd["fcn.bias"] = _f32(p["fcn"]["bias"])
    return sd


# --- metrics (stgcn/{accuracy,diversity}.py) ------------------------------------


def calculate_accuracy(yhat: np.ndarray, y: np.ndarray, num_labels: int):
    """Logits (N, L) + labels (N,) -> (accuracy, confusion matrix)."""
    confusion = np.zeros((num_labels, num_labels), dtype=np.int64)
    pred = np.argmax(yhat, axis=1)
    np.add.at(confusion, (np.asarray(y), pred), 1)
    return float(np.trace(confusion) / confusion.sum()), confusion


def calculate_diversity_multimodality(activations: np.ndarray,
                                      labels: np.ndarray, num_labels: int,
                                      seed: Optional[int] = None,
                                      unconstrained: bool = False):
    """Same estimator AND same MT19937 draw sequence as the reference
    (stgcn/diversity.py:6-53), so seeded values reproduce it exactly."""
    diversity_times = 200
    multimodality_times = 20
    num_motions = activations.shape[0]
    rng = np.random.RandomState(seed) if seed is not None else np.random

    first = rng.randint(0, num_motions, diversity_times)
    second = rng.randint(0, num_motions, diversity_times)
    diversity = float(np.mean(
        np.linalg.norm(activations[first] - activations[second], axis=1)))

    if unconstrained:
        return diversity, float("nan")

    labels = np.asarray(labels)
    multimodality = 0.0
    quotas = np.zeros(num_labels)
    quotas[np.unique(labels)] = multimodality_times
    while np.any(quotas > 0):
        first_idx = rng.randint(0, num_motions)
        first_label = labels[first_idx]
        if not quotas[first_label]:
            continue
        second_idx = rng.randint(0, num_motions)
        while first_label != labels[second_idx]:
            second_idx = rng.randint(0, num_motions)
        quotas[first_label] -= 1
        multimodality += np.linalg.norm(
            activations[first_idx] - activations[second_idx])
    multimodality /= multimodality_times * num_labels
    return diversity, float(multimodality)


# --- evaluation wrapper (stgcn/evaluate.py) -------------------------------------

class A2MEvaluation:
    """Runs an STGCN over motion loaders and computes accuracy / FID /
    diversity / multimodality. Loaders yield dicts with 'output' (N, V, C, T)
    motions and 'y' labels. state_dict: the reference layout
    (`uestc_rot6d_stgcn.tar`); None initialises the network from `init_seed`."""

    def __init__(self, state_dict: Optional[Mapping], in_channels: int, num_classes: int,
                 layout: str = "smpl", seed: Optional[int] = None, init_seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.graph = Graph(layout=layout, strategy="spatial")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(init_seed)
            self.model = STGCN(in_channels, num_classes, self.graph)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval().requires_grad_(False)
        self.num_classes = num_classes
        self.seed = seed

    def compute_features(self, loader: Iterable[dict]):
        feats, logits, labels = [], [], []
        for batch in loader:
            with torch.no_grad():
                f, yh = self.model(torch.as_tensor(np.asarray(batch["output"], np.float32),
                                                   device=self.device))
            feats.append(f.cpu().numpy())
            logits.append(yh.cpu().numpy())
            if "y" in batch:
                labels.append(np.asarray(batch["y"]))
        return (np.concatenate(feats), np.concatenate(logits),
                np.concatenate(labels) if labels else None)

    def evaluate(self, loaders: Dict[str, Iterable[dict]]) -> dict:
        computed = {name: self.compute_features(loader) for name, loader in loaders.items()}
        gt_feats = computed["gt"][0]
        metrics: dict = {}
        for name, (feats, logits, labels) in computed.items():
            if labels is not None:
                metrics[f"{name}_accuracy"], _ = calculate_accuracy(logits, labels,
                                                                    self.num_classes)
            metrics[f"{name}_fid"] = frechet_distance(gt_feats, feats)
            div, mm = calculate_diversity_multimodality(
                feats, labels, self.num_classes, seed=self.seed, unconstrained=labels is None)
            metrics[f"{name}_diversity"] = div
            metrics[f"{name}_multimodality"] = mm
        return metrics
