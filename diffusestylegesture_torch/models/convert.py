"""Weights into the port: reference checkpoints and the JAX package's params.

* `load_reference_mdm` / `load_reference_mdm_plus` / `load_wavlm_checkpoint`:
  the reference's released `.pt` files (ZEGGS `model000450000.pt`, the BEAT/TWH
  `model001200000.pt`, `WavLM-Large.pt`). The port's
  modules carry the reference's names, so only `clip_model.*` and unused
  buffers are dropped, and the WavLM pos-conv weight norm is folded
  (`g·v/‖v‖` over every dim but 2, as the JAX package's
  `models/wavlm/convert.py:29-59` does).
* `mdm_state_dict_from_flax` / `mdm_plus_state_dict_from_flax` /
  `wavlm_state_dict_from_flax`: the JAX package's parameter trees (nested
  dicts of numpy arrays) → the port's state_dict. Dense kernels (in, out) transpose to (out, in); LayerNorm
  `scale` → `weight`; `layers_i` → `layers.i`; Conv (k, in, out) → (out, in, k).
* `autoencoder_state_dict_from_flax`: the JAX evaluation autoencoder
  (`eval/embedding.py`) → the port's `GestureAutoencoder`; a ConvTranspose
  kernel (k, in, out) becomes (in, out, k) flipped along its taps.
* `train_state_from_flax`: a JAX `TrainState`'s params, `optax.adamw` state
  and EMA → the port's model state_dict, `train.state.AdamW` state_dict and
  EMA, the moments through the same naming, so both trainers can start from
  one state mid-run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .mdm import MDM, MDMConfig
from .mdm_plus import MDMPlus, MDMPlusConfig
from .wavlm.model import WavLM, WavLMConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(out: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(out: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(2, 1, 0))


def _unwrap(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def encoder_layer_state_dict_from_flax(lp: Mapping[str, Any], prefix: str = "") -> StateDict:
    """JAX `TorchEncoderLayer` params → `nn.TransformerEncoderLayer` names."""
    sd: StateDict = {}
    sd[f"{prefix}self_attn.in_proj_weight"] = _t(np.asarray(lp["self_attn"]["in_proj"]["kernel"]).T)
    sd[f"{prefix}self_attn.in_proj_bias"] = _t(lp["self_attn"]["in_proj"]["bias"])
    _dense(sd, f"{prefix}self_attn.out_proj", lp["self_attn"]["out_proj"])
    _dense(sd, f"{prefix}linear1", lp["linear1"])
    _dense(sd, f"{prefix}linear2", lp["linear2"])
    _layernorm(sd, f"{prefix}norm1", lp["norm1"])
    _layernorm(sd, f"{prefix}norm2", lp["norm2"])
    return sd


def mdm_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.mdm.MDM` params → the port's `MDM` state_dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    _dense(sd, "embed_timestep.time_embed.0", p["embed_timestep"]["time_embed_0"])
    _dense(sd, "embed_timestep.time_embed.2", p["embed_timestep"]["time_embed_2"])
    _dense(sd, "embed_style", p["embed_style"])
    _dense(sd, "embed_text", p["embed_text"])
    _dense(sd, "WavEncoder.audio_feature_map", p["WavEncoder"]["audio_feature_map"])
    _dense(sd, "input_process.poseEmbedding", p["input_process"]["poseEmbedding"])
    _dense(sd, "input_process2", p["input_process2"])
    _dense(sd, "output_process.poseFinal", p["output_process"]["poseFinal"])
    enc = p["seqTransEncoder"]
    for i in range(len([k for k in enc if k.startswith("layers_")])):
        sd.update(encoder_layer_state_dict_from_flax(enc[f"layers_{i}"],
                                                     f"seqTransEncoder.layers.{i}."))
    return sd


def mdm_plus_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.mdm_plus.MDMPlus` params → the port's `MDMPlus` state_dict:
    the MDM's names, and `embed_text_last` where the params have it
    (cross_local_attention5). Also right for the ZEGGS MDM's params."""
    sd = mdm_state_dict_from_flax(params)
    p = _unwrap(params)
    if "embed_text_last" in p:
        _dense(sd, "embed_text_last", p["embed_text_last"])
    return sd


def autoencoder_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `GestureAutoencoder` params → `eval.embedding.GestureAutoencoder`
    names. flax's ConvTranspose correlates the dilated input with its kernel
    as it is (`transpose_kernel=False`), torch's is the adjoint of a
    correlation: the taps are flipped."""
    p = _unwrap(params)
    sd: StateDict = {}
    for name in ("conv1", "conv2"):
        sd[f"encoder.{name}.weight"] = _conv(p["encoder"][name]["kernel"])
        sd[f"encoder.{name}.bias"] = _t(p["encoder"][name]["bias"])
    for name in ("deconv1", "deconv2"):
        sd[f"decoder.{name}.weight"] = _t(np.asarray(p["decoder"][name]["kernel"])[::-1]
                                          .transpose(1, 2, 0))
        sd[f"decoder.{name}.bias"] = _t(p["decoder"][name]["bias"])
    _dense(sd, "encoder.proj", p["encoder"]["proj"])
    _dense(sd, "decoder.proj", p["decoder"]["proj"])
    return sd


def _adam_states(tree) -> Dict[str, Any]:
    """The leaves of an `optax.adamw` state (bare or inside `apply_if_finite`,
    as namedtuples or as dicts): count, mu, nu and, if present, the
    non-finite counters."""
    out: Dict[str, Any] = {}

    def get(node, key):
        return node[key] if isinstance(node, Mapping) else getattr(node, key)

    def has(node, key):
        return key in node if isinstance(node, Mapping) else hasattr(node, key)

    def walk(node):
        if has(node, "mu") and has(node, "nu") and "mu" not in out:
            out.update(count=get(node, "count"), mu=get(node, "mu"), nu=get(node, "nu"))
            return
        if has(node, "notfinite_count"):
            out.update(notfinite_count=get(node, "notfinite_count"),
                       total_notfinite=get(node, "total_notfinite"))
        children = node.values() if isinstance(node, Mapping) else (
            node if isinstance(node, (tuple, list)) else ())
        for child in children:
            walk(child)

    walk(tree)
    if "mu" not in out:
        raise ValueError("train_state_from_flax: no optax Adam state (count, mu, nu) found")
    return out


def train_state_from_flax(params: Mapping[str, Any], opt_state, ema_params: Optional[Mapping],
                          step: int) -> Dict[str, Any]:
    """JAX `TrainState` parts (numpy leaves) → {'model': state_dict, 'ema':
    state_dict or None, 'step', 'optimizer': `AdamW.state_dict()`, 'loss_aware':
    None}; `TrainState.load_state_dict(d, d['model'], d['ema'])` takes it."""
    adam = _adam_states(opt_state)
    optimizer = {"count": torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32),
                 "mu": mdm_state_dict_from_flax(adam["mu"]),
                 "nu": mdm_state_dict_from_flax(adam["nu"])}
    for k in ("notfinite_count", "total_notfinite"):
        if k in adam:
            optimizer[k] = torch.tensor(int(np.asarray(adam[k])), dtype=torch.int32)
    return {"model": mdm_state_dict_from_flax(params),
            "ema": None if ema_params is None else mdm_state_dict_from_flax(ema_params),
            "step": int(np.asarray(step)), "optimizer": optimizer, "loss_aware": None}


def wavlm_state_dict_from_flax(params: Mapping[str, Any], cfg: WavLMConfig) -> StateDict:
    """JAX `models.wavlm.WavLM` params → the port's `WavLM` state_dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.0.weight"] = _conv(fe[f"conv_{i}"]["kernel"])
        if "bias" in fe[f"conv_{i}"]:
            sd[f"{pre}.0.bias"] = _t(fe[f"conv_{i}"]["bias"])
        if cfg.extractor_mode == "layer_norm":
            _layernorm(sd, f"{pre}.2.1", fe[f"ln_{i}"])
        elif i == 0:
            sd[f"{pre}.2.weight"] = _t(fe["gn_scale"])
            sd[f"{pre}.2.bias"] = _t(fe["gn_bias"])
    _layernorm(sd, "layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _dense(sd, "post_extract_proj", p["post_extract_proj"])
    sd["encoder.pos_conv.0.weight"] = _conv(p["pos_conv"]["kernel"])
    sd["encoder.pos_conv.0.bias"] = _t(p["pos_conv"]["bias"])
    _layernorm(sd, "encoder.layer_norm", p["encoder_layer_norm"])
    for i in range(cfg.encoder_layers):
        lp, pre = p[f"layers_{i}"], f"encoder.layers.{i}"
        a = lp["self_attn"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{pre}.self_attn.{name}", a[name])
        if cfg.gru_rel_pos:
            _dense(sd, f"{pre}.self_attn.grep_linear", a["grep_linear"])
            sd[f"{pre}.self_attn.grep_a"] = _t(a["grep_a"])
        if "relative_attention_bias" in a:
            sd[f"{pre}.self_attn.relative_attention_bias.weight"] = _t(a["relative_attention_bias"])
        _layernorm(sd, f"{pre}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _dense(sd, f"{pre}.fc1", lp["fc1"])
        _dense(sd, f"{pre}.fc2", lp["fc2"])
        _layernorm(sd, f"{pre}.final_layer_norm", lp["final_layer_norm"])
    return sd


def _load_into(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    """Load the keys the module has; every one of them must be present."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{what}: checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    module.load_state_dict({k: sd[k] for k in own}, strict=True)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """torch weight_norm(dim) fold: w = g · v / ‖v‖ over every dim but `dim`."""
    dims = tuple(i for i in range(v.dim()) if i != dim)
    return g * v / v.pow(2).sum(dim=dims, keepdim=True).sqrt()


def _load_reference(path: str, model: torch.nn.Module,
                    device: Union[str, torch.device]) -> torch.nn.Module:
    """A reference-layout `.pt` (bare state_dict or {'model_state_dict': …})
    into `model`, which moves to `device` in eval mode. `clip_model.*` and
    the buffers the port recomputes are not read. `weights_only=True`: a
    malicious checkpoint cannot run code."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    sd = {k: v for k, v in sd.items() if not k.startswith("clip_model.")}
    _load_into(model, sd, path)
    return model.to(dev).eval()


def load_reference_mdm(path: str, cfg: MDMConfig = MDMConfig(),
                       device: Union[str, torch.device] = "cuda") -> MDM:
    """A reference-layout ZEGGS MDM `.pt` → an eval-mode `MDM` on `device`."""
    return _load_reference(path, MDM(cfg), device)


def load_reference_mdm_plus(path: str, cfg: MDMPlusConfig = MDMPlusConfig(),
                            device: Union[str, torch.device] = "cuda") -> MDMPlus:
    """A reference-layout BEAT/TWH MDM `.pt` (the counterpart of the JAX
    `convert_mdm_beat_twh`), or the port's own `model.pt` of one → an
    eval-mode `MDMPlus` on `device`."""
    return _load_reference(path, MDMPlus(cfg), device)


def load_wavlm_checkpoint(path: str, device: Union[str, torch.device] = "cuda",
                          dtype: torch.dtype = torch.float32):
    """`WavLM-Large.pt` layout ({'cfg': dict, 'model': state_dict}) →
    (WavLMConfig, eval-mode `WavLM` on `device`); `dtype=torch.bfloat16`
    casts the weights and runs the encoder in bf16 (`WavLMConfig.dtype`)."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cfg = dataclasses.replace(WavLMConfig.from_torch_cfg(ckpt["cfg"]), dtype=dtype)
    sd = dict(ckpt["model"])
    g = sd.pop("encoder.pos_conv.0.weight_g", None)
    v = sd.pop("encoder.pos_conv.0.weight_v", None)
    if g is not None and v is not None:
        sd["encoder.pos_conv.0.weight"] = fold_weight_norm(g.float(), v.float(), dim=2)
    model = WavLM(cfg)
    _load_into(model, sd, path)
    return cfg, model.to(dev).eval()
