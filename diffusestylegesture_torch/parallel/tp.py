"""Tensor parallelism (Megatron) for the denoisers' trunks and WavLM.

Port of `diffusestylegesture_tpu/parallel/tp.py`. The JAX package annotates
the trunk's weights with PartitionSpecs over a `model` mesh axis and GSPMD
inserts the collectives. The port computes the same pairing explicitly,
one process per card:

* attention q / k / v and MLP `linear1` are column-parallel: rank r of the
  `model` group computes heads [r·H/tp, (r+1)·H/tp) and hidden units
  [r·F/tp, (r+1)·F/tp), reading those rows of the weights;
* attention `out_proj` and MLP `linear2` are row-parallel: each rank
  multiplies its heads / hidden units by its columns of the weight, and one
  all-reduce sums the partial outputs (`comm.reduce_from`, Megatron's g); the
  gradient of the layer's input is all-reduced on the way back
  (`comm.copy_to`, f);
* everything else (embeddings, norms, row-parallel biases) is replicated.

The shards are slices of the full weights, which every rank keeps as views
of its flat buffer (`train/state.py::FlatParams`): a backward leaves each
rank the gradient of its own slices (and zeros elsewhere) and the full
gradient of the replicated parameters, and the trainer sums the former over
the group. Head-aligned (`heads % tp == 0`), on the packed `in_proj` and on
the split q / k / v layout alike; `--tp` turns on the split layout, as in
the JAX CLI.

Plans (`mdm_param_specs`, `wavlm_param_specs`) are {parameter name: spec}
over the port's state dicts, in torch's layout (a Linear weight is (out,
in), so a column-parallel weight is sharded on dimension 0, `("model",)`;
trailing Nones are dropped): the same leaves and physical dimensions as the
JAX specs. `split_qkv_params` /
`merge_qkv_params` convert state dicts, and any dict holding them (AdamW's
moments, the EMA, a checkpoint), between the packed and the split layout,
exactly. `shard_params` / `shard_train_state` cut a rank's slices.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from . import comm

Spec = tuple


def _col(name: str) -> bool:
    return any(s in name for s in ("in_proj", "linear1", "q_proj", "k_proj", "v_proj"))


def mdm_param_specs(params: Mapping[str, Any], model_axis: str = "model") -> Dict[str, Spec]:
    """{name: spec} for an MDM / MDMPlus / TextMDM state dict: the trunk's
    (`seqTransEncoder`) q/k/v (packed or split) and linear1 weights and biases
    column-parallel, out_proj and linear2 weights row-parallel, the rest
    replicated."""
    out = {}
    for name, leaf in params.items():
        ndim = len(leaf.shape) if hasattr(leaf, "shape") else len(leaf)
        spec: Spec = ()
        if "seqTransEncoder" in name and ndim == 2:
            if _col(name):
                spec = (model_axis,)
            elif "out_proj" in name or "linear2" in name:
                spec = (None, model_axis)
        elif "seqTransEncoder" in name and ndim == 1 and _col(name):
            spec = (model_axis,)
        out[name] = spec
    return out


_WAVLM_LAYER = re.compile(r"(^|\.)encoder\.layers\.\d+\.")


def wavlm_param_specs(params: Mapping[str, Any], model_axis: str = "model") -> Dict[str, Spec]:
    """{name: spec} for the port's WavLM: in every encoder layer q / k / v and
    fc1 column-parallel, out_proj and fc2 row-parallel, the relative-position
    bias table (buckets, H) and `grep_a` (1, H, 1, 1) on the head dimension;
    the conv extractor, positional conv and norms replicated."""
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        spec: Spec = ()
        if _WAVLM_LAYER.search(name):
            col = any(s in name for s in ("q_proj", "k_proj", "v_proj", "fc1"))
            if len(shape) == 2:
                if col:
                    spec = (model_axis,)
                elif "out_proj" in name or "fc2" in name:
                    spec = (None, model_axis)
                elif "relative_attention_bias" in name:
                    spec = (None, model_axis)
            elif len(shape) == 1 and col:
                spec = (model_axis,)
            elif "grep_a" in name and len(shape) == 4:
                spec = (None, model_axis)
        out[name] = spec
    return out


_QKV = ("q_proj", "k_proj", "v_proj")


def _is_state_dict(d: Mapping) -> bool:
    return any(isinstance(k, str) and k.endswith(("in_proj_weight", "q_proj.weight"))
               for k in d)


def _convert_qkv(tree: Any, scope: str, to_split: bool) -> Any:
    if not isinstance(tree, Mapping):
        return tree
    if not _is_state_dict(tree):
        return {k: _convert_qkv(v, scope, to_split) for k, v in tree.items()}
    out = {}
    for k, v in tree.items():
        if to_split and scope in k and k.endswith(("in_proj_weight", "in_proj_bias")):
            pre, kind = k.rsplit(".", 1)
            for name, part in zip(_QKV, v.chunk(3, dim=0)):
                out[f"{pre}.{name}.{kind.split('_')[-1]}"] = part.clone()
        elif not to_split and scope in k and re.search(r"\.q_proj\.(weight|bias)$", k):
            pre, name, kind = k.rsplit(".", 2)
            if f"{pre}.v_proj.{kind}" not in tree or f"{pre}.k_proj.{kind}" not in tree:
                out[k] = v
                continue
            out[f"{pre}.in_proj_{kind}"] = torch.cat([tree[f"{pre}.{n}.{kind}"] for n in _QKV])
        elif not to_split and scope in k and re.search(r"\.(k|v)_proj\.(weight|bias)$", k) \
                and f"{k.rsplit('.', 2)[0]}.q_proj.{k.rsplit('.', 1)[1]}" in tree:
            continue
        else:
            out[k] = v
    return out


def split_qkv_params(tree: Any, scope: str = "seqTransEncoder") -> Any:
    """Packed `self_attn.in_proj_weight` (3D, D) / `in_proj_bias` (3D,) of every
    attention under `scope` → `self_attn.{q,k,v}_proj.weight` (D, D) / `.bias`,
    in a state dict or in any dict of state dicts (moments, EMA, a saved train
    state). Exact: a cut along the output dimension. WavLM and the local block
    are outside the scope."""
    return _convert_qkv(tree, scope, to_split=True)


def merge_qkv_params(tree: Any, scope: str = "seqTransEncoder") -> Any:
    """The inverse of `split_qkv_params`: back to the reference's packed layout."""
    return _convert_qkv(tree, scope, to_split=False)


def _local_slice(t: torch.Tensor, spec: Spec, coords: Mapping[str, tuple]) -> torch.Tensor:
    for d, axis in enumerate(spec):
        if axis is None or axis not in coords:
            continue
        n, r = coords[axis]
        t = t.chunk(n, dim=d)[r]
    return t


def _coords(mesh) -> Dict[str, tuple]:
    return {a: (mesh.size(i), mesh.get_local_rank(a)) for i, a in enumerate(mesh.mesh_dim_names)}


def shard_params(mesh, params: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Spec]) -> Dict[str, torch.Tensor]:
    """This rank's slice of each parameter under its spec (a copy)."""
    coords = _coords(mesh)
    return {k: _local_slice(v, tuple(specs.get(k, ())), coords).clone() for k, v in params.items()}


def shard_train_state(mesh, state: Mapping[str, Any], specs: Mapping[str, Spec]) -> Dict:
    """`shard_params` applied to every state dict in a saved train state
    ({'model', 'ema', 'optimizer': {'mu', 'nu', …}, …}): the weights, the EMA
    and AdamW's moments, which mirror the weights element by element."""
    def rec(node):
        if isinstance(node, Mapping) and node and all(k in specs for k in node):
            return shard_params(mesh, node, specs)
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        return node

    return rec(state)


class TPGroup:
    """A `model` process group as the trunk sees it: size, this rank's index,
    and the rank's slice of a dimension of `n` units."""

    def __init__(self, group):
        self.group = group
        self.size = comm.size(group)
        self.rank = comm.rank(group)

    def slice(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"{n} units do not divide over tensor-parallel degree {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def tensor_parallel_trunk(model: torch.nn.Module, group) -> int:
    """Run every encoder trunk of `model` (its `TorchTransformerEncoder`s)
    Megatron-style over `group`; returns how many were set. Requires
    `heads % tp == 0`."""
    from ..models.transformer import TorchTransformerEncoder

    tp = TPGroup(group)
    n = 0
    for m in model.modules():
        if isinstance(m, TorchTransformerEncoder):
            heads = m.layers[0].self_attn.num_heads
            if heads % tp.size:
                raise ValueError(f"tensor parallelism needs heads % tp == 0 "
                                 f"(heads {heads}, tp {tp.size})")
            m.tp = tp
            n += 1
    return n


def wavlm_tp_forward(model, source: torch.Tensor, group,
                     padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The port's `WavLM.forward` with every encoder layer Megatron-parallel
    over `group` (heads and FFN units split, one all-reduce after out_proj
    and one after fc2); the rest runs replicated. Requires
    `encoder_attention_heads % tp == 0`."""
    from ..models.wavlm.model import _ln

    cfg = model.cfg
    tp = TPGroup(group)
    H = cfg.encoder_attention_heads
    heads = tp.slice(H)
    feats = _ln(model.layer_norm, model.feature_extractor(source.to(cfg.dtype)))
    if model.post_extract_proj is not None:
        feats = model.post_extract_proj(feats)
    pos = model.encoder.pos_conv[0](feats.transpose(1, 2)).transpose(1, 2)
    if cfg.conv_pos % 2 == 0:
        pos = pos[:, :-1]
    x = feats + F.gelu(pos)
    if not cfg.layer_norm_first:
        x = _ln(model.encoder.layer_norm, x)
    position_bias = None
    for layer in model.encoder.layers:
        a = layer.self_attn
        D = a.D
        hd = D // H
        rows = slice(heads.start * hd, heads.stop * hd)
        if a.has_relative_attention_bias and position_bias is None:
            from ..models.wavlm.model import relative_position_bucket

            T = x.shape[1]
            p = torch.arange(T, device=x.device)
            buckets = relative_position_bucket(p[None, :] - p[:, None], cfg.num_buckets,
                                               cfg.max_distance)
            position_bias = a.relative_attention_bias(buckets).permute(2, 0, 1)  # (H, T, T)

        def attn(h):
            B, T, _ = h.shape
            hl = heads.stop - heads.start
            h = comm.copy_to(h, group)
            q, k, v = (F.linear(h, m.weight[rows], m.bias[rows]).reshape(B, T, hl, hd)
                       .transpose(1, 2) for m in (a.q_proj, a.k_proj, a.v_proj))
            sim = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)).float()
            if position_bias is not None:
                bias = position_bias[heads][None]
                if cfg.gru_rel_pos:
                    gates = torch.sigmoid(a.grep_linear(q).reshape(B, hl, T, 2, 4).sum(-1))
                    bias = (gates[..., 0:1] * (gates[..., 1:2] * a.grep_a[:, heads] - 1.0)
                            + 2.0) * bias
                sim = sim + bias
            if padding_mask is not None:
                sim = sim.masked_fill(padding_mask[:, None, None, :],
                                      torch.finfo(torch.float32).min)
            out = torch.matmul(torch.softmax(sim, dim=-1).to(v.dtype), v)
            out = out.transpose(1, 2).reshape(B, T, hl * hd)
            return comm.reduce_from(F.linear(out, a.out_proj.weight[:, rows]), group) \
                + a.out_proj.bias

        def ffn(h):
            units = tp.slice(layer.fc1.out_features)
            h = comm.copy_to(h, group)
            h = F.gelu(F.linear(h, layer.fc1.weight[units], layer.fc1.bias[units]))
            return comm.reduce_from(F.linear(h, layer.fc2.weight[:, units]), group) \
                + layer.fc2.bias

        if layer.layer_norm_first:
            x = x + attn(_ln(layer.self_attn_layer_norm, x))
            x = x + ffn(_ln(layer.final_layer_norm, x))
        else:
            x = _ln(layer.self_attn_layer_norm, x + attn(x))
            x = _ln(layer.final_layer_norm, x + ffn(x))
    if cfg.layer_norm_first:
        x = _ln(model.encoder.layer_norm, x)
    return x
