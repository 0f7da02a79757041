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
  Every conditioning mode and trunk of the MDM is covered: `input_process_plain`,
  `embed_style` under style2, `seqTransDecoder`, `gru` and a MoE layer's
  router and expert stacks.
* `text_mdm_state_dict_from_flax`: the JAX text-to-motion `TextMDM`; its
  CLIP text encoder's params go through
  `models/clip_text.py::clip_state_dict_from_flax`.
* `tisa_state_dict_from_flax`, `local_transformer_state_dict_from_flax`,
  `baseline_state_dict_from_flax` (GeneratorLinear / GRU, Seq2SeqNet: the
  reference's own layout, the inverse of the JAX `convert_*`),
  `generator_diff_state_dict_from_flax`, `diffwav_state_dict_from_flax`: the
  other models of `models/`.
* `autoencoder_state_dict_from_flax`: the JAX evaluation autoencoder
  (`eval/embedding.py`) → the port's `GestureAutoencoder`; a ConvTranspose
  kernel (k, in, out) becomes (in, out, k) flipped along its taps.
* `zeroeggs_state_dict_from_flax`: the JAX ZeroEGGS networks' params
  ({'speech', 'style', 'decoder'}) → the port's `models.zeroeggs.ZeroEGGS`;
  a GRU's `ih` / `hh` Dense pair becomes torch's `weight_ih` / `weight_hh`
  (+ biases), the backward direction `_reverse`.
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
from ..utils.precision import bf16_cast
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
    """JAX `TorchEncoderLayer` params → `nn.TransformerEncoderLayer` names; a
    MoE layer's `moe` scope (router, w1, b1, w2, b2) → `moe.*` as it is."""
    sd: StateDict = {}
    _attention(sd, f"{prefix}self_attn", lp["self_attn"])
    if "moe" in lp:
        m = lp["moe"]
        _dense(sd, f"{prefix}moe.router", m["router"])
        for name in ("w1", "b1", "w2", "b2"):
            sd[f"{prefix}moe.{name}"] = _t(m[name])
    else:
        _dense(sd, f"{prefix}linear1", lp["linear1"])
        _dense(sd, f"{prefix}linear2", lp["linear2"])
    _layernorm(sd, f"{prefix}norm1", lp["norm1"])
    _layernorm(sd, f"{prefix}norm2", lp["norm2"])
    return sd


def _attention(sd: StateDict, prefix: str, a: Mapping[str, Any]) -> None:
    """JAX `TorchMultiheadAttention` (packed in_proj, or the split_qkv layout's
    q_proj / k_proj / v_proj, and out_proj) → torch names."""
    if "in_proj" in a:
        sd[f"{prefix}.in_proj_weight"] = _t(np.asarray(a["in_proj"]["kernel"]).T)
        sd[f"{prefix}.in_proj_bias"] = _t(a["in_proj"]["bias"])
    else:
        for name in ("q_proj", "k_proj", "v_proj"):
            _dense(sd, f"{prefix}.{name}", a[name])
    _dense(sd, f"{prefix}.out_proj", a["out_proj"])


def _gru(sd: StateDict, prefix: str, tree: Mapping[str, Any]) -> None:
    """JAX `TorchGRU` cells `l{i}_fwd|bwd` ({ih, hh} Dense) → `nn.GRU`'s
    `weight_ih_l{i}[_reverse]` and friends."""
    for name, cell in tree.items():
        layer, direction = name[1:].split("_")
        suffix = f"l{layer}" + ("_reverse" if direction == "bwd" else "")
        for gate in ("ih", "hh"):
            sd[f"{prefix}.weight_{gate}_{suffix}"] = _t(np.asarray(cell[gate]["kernel"]).T)
            sd[f"{prefix}.bias_{gate}_{suffix}"] = _t(cell[gate]["bias"])


def _layers(tree: Mapping[str, Any]) -> int:
    return len([k for k in tree if k.startswith("layers_")])


def mdm_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.mdm.MDM` (or `MDMPlus`) params, any conditioning mode and
    trunk → the port's state_dict: the scopes present are carried
    (`embed_style`, `embed_text`, `embed_text_last`, `WavEncoder`,
    `input_process2`, `input_process_plain`, `seqTransEncoder` with dense or
    MoE layers, `seqTransDecoder`, `gru`)."""
    p = _unwrap(params)
    sd: StateDict = {}
    _dense(sd, "embed_timestep.time_embed.0", p["embed_timestep"]["time_embed_0"])
    _dense(sd, "embed_timestep.time_embed.2", p["embed_timestep"]["time_embed_2"])
    for name in ("embed_style", "embed_text", "embed_text_last", "input_process2",
                 "input_process_plain"):
        if name in p:
            _dense(sd, name, p[name])
    if "WavEncoder" in p:
        _dense(sd, "WavEncoder.audio_feature_map", p["WavEncoder"]["audio_feature_map"])
    _dense(sd, "input_process.poseEmbedding", p["input_process"]["poseEmbedding"])
    _dense(sd, "output_process.poseFinal", p["output_process"]["poseFinal"])
    if "seqTransEncoder" in p:
        enc = p["seqTransEncoder"]
        for i in range(_layers(enc)):
            sd.update(encoder_layer_state_dict_from_flax(enc[f"layers_{i}"],
                                                         f"seqTransEncoder.layers.{i}."))
    if "seqTransDecoder" in p:
        dec = p["seqTransDecoder"]
        for i in range(_layers(dec)):
            lp, pre = dec[f"layers_{i}"], f"seqTransDecoder.layers.{i}"
            _attention(sd, f"{pre}.self_attn", lp["self_attn"])
            _attention(sd, f"{pre}.multihead_attn", lp["multihead_attn"])
            _dense(sd, f"{pre}.linear1", lp["linear1"])
            _dense(sd, f"{pre}.linear2", lp["linear2"])
            for norm in ("norm1", "norm2", "norm3"):
                _layernorm(sd, f"{pre}.{norm}", lp[norm])
    if "gru" in p:
        _gru(sd, "gru", p["gru"])
    return sd


def mdm_plus_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.mdm_plus.MDMPlus` params → the port's `MDMPlus` state_dict
    (the MDM's scopes, `embed_text_last` in cross_local_attention5, MoE layers)."""
    return mdm_state_dict_from_flax(params)


def text_mdm_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.mdm_text.TextMDM` params → the port's `TextMDM` state_dict
    (`embed_timestep`, `embed_text`, `input_process`, `seqTransEncoder`,
    `output_process`)."""
    return mdm_state_dict_from_flax(params)


def _generic(sd: StateDict, prefix: str, tree: Mapping[str, Any], rename=lambda k: k) -> None:
    """A flax param tree → torch names by the kind of each leaf dict: a Dense
    kernel (in, out) → weight (out, in), a Conv kernel (k, in, out) →
    (out, in, k), LayerNorm / GroupNorm `scale` → weight, an Embed's
    `embedding` → weight; any other array as it is. `rename` maps each path
    segment to the port's (e.g. `layers_3` → `layers.3`)."""
    if "kernel" in tree:
        k = np.asarray(tree["kernel"])
        sd[f"{prefix}.weight"] = _conv(k) if k.ndim == 3 else _t(k.T)
        if "bias" in tree:
            sd[f"{prefix}.bias"] = _t(tree["bias"])
        return
    if "scale" in tree:
        _layernorm(sd, prefix, tree)
        return
    if "embedding" in tree:
        sd[f"{prefix}.weight"] = _t(tree["embedding"])
        return
    for name, sub in tree.items():
        key = f"{prefix}.{rename(name)}" if prefix else rename(name)
        if isinstance(sub, Mapping):
            _generic(sd, key, sub, rename)
        else:
            sd[key] = _t(sub)


def _wav_encoder(sd: StateDict, prefix: str, tree: Mapping[str, Any]) -> None:
    """JAX baselines `WavEncoder` (l0..l3: conv + eval BatchNorm params) → the
    reference's `feat_extractor` Sequential (conv at 0/3/6/9, BatchNorm1d at
    1/4/7 with its running statistics)."""
    for i in range(4):
        lp, idx = tree[f"l{i}"], 3 * i
        _generic(sd, f"{prefix}.feat_extractor.{idx}", lp["conv"])
        if i < 3:
            _batchnorm(sd, f"{prefix}.feat_extractor.{idx + 1}", lp)


def _batchnorm(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.running_mean"] = _t(p["bn_mean"])
    sd[f"{prefix}.running_var"] = _t(p["bn_var"])
    sd[f"{prefix}.weight"] = _t(p["bn_scale"])
    sd[f"{prefix}.bias"] = _t(p["bn_bias"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def baseline_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.baselines` params (`GeneratorLinear`, `GeneratorGRU`,
    `Seq2SeqNet`; also `GeneratorDiff` / `DiffWavModel`, whose other scopes go
    through `_generic`) → the reference's state_dict layout, which the port's
    modules carry."""
    p = _unwrap(params)
    sd: StateDict = {}
    for name, sub in p.items():
        if name == "WavEncoder":
            _wav_encoder(sd, "WavEncoder", sub)
        elif name == "project" and "l0_fwd" in sub:  # GeneratorGRU's GRU
            _gru(sd, "project", sub)
        elif name == "encoder":  # Seq2SeqNet
            _generic(sd, "encoder.embedding", sub["embedding"])
            _gru(sd, "encoder.gru", sub["gru"])
        elif name == "decoder":
            pre = "decoder.decoder"
            _generic(sd, f"{pre}.attn.attn", sub["attn"]["attn"])
            sd[f"{pre}.attn.v"] = _t(sub["attn"]["v"])
            _generic(sd, f"{pre}.pre_linear.0", sub["pre_linear_fc"])
            _batchnorm(sd, f"{pre}.pre_linear.1", sub)
            for gate in ("ih", "hh"):
                sd[f"{pre}.gru.weight_{gate}_l0"] = _t(np.asarray(sub["gru_cell"][gate]["kernel"]).T)
                sd[f"{pre}.gru.bias_{gate}_l0"] = _t(sub["gru_cell"][gate]["bias"])
            _generic(sd, f"{pre}.out", sub["out"])
        else:
            _generic(sd, name, sub, _baseline_rename)
    return sd


def _baseline_rename(seg: str) -> str:
    """UNet1D / DiffWave1D scope names → the port's module paths."""
    if seg.endswith(("_downsample", "_upsample")):
        return f"convs.{seg}"
    if "_block" in seg or seg.startswith("final_block"):
        return f"blocks.{seg}"
    if seg.startswith("layer") and seg[5:].isdigit():
        return f"layers.{seg[5:]}"
    return seg


def generator_diff_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.unet1d.GeneratorDiff` params → `models.unet1d.GeneratorDiff`."""
    return baseline_state_dict_from_flax(params)


def diffwav_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.diffwav.DiffWavModel` params → `models.diffwav.DiffWavModel`."""
    return baseline_state_dict_from_flax(params)


def tisa_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.tisa.Tisa` params → `models.tisa.Tisa` (same names)."""
    return {k: _t(v) for k, v in _unwrap(params).items()}


def local_transformer_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.local_transformer.LocalTransformer` params → the port's:
    `attn_i` / `ff_i` → `attn.i` / `ff.i`."""
    sd: StateDict = {}

    def rename(seg: str) -> str:
        head, _, idx = seg.rpartition("_")
        return f"{head}.{idx}" if head in ("attn", "ff") and idx.isdigit() else seg

    _generic(sd, "", _unwrap(params), rename)
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


def zeroeggs_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """JAX ZeroEGGS params {'speech', 'style', 'decoder'} (each bare or under
    'params', numpy leaves) → a state_dict of `models.zeroeggs.ZeroEGGS`."""
    sd: StateDict = {}

    def walk(prefix: str, tree: Mapping[str, Any]) -> None:
        if "kernel" in tree:
            k = np.asarray(tree["kernel"])
            sd[f"{prefix}.weight"] = _conv(k) if k.ndim == 3 else _t(k.T)
            sd[f"{prefix}.bias"] = _t(tree["bias"])
        elif "scale" in tree:
            _layernorm(sd, prefix, tree)
        elif "in_proj" in tree:  # TorchMultiheadAttention: packed in-projection
            _attention(sd, prefix, tree)
        else:
            for name, sub in tree.items():
                if name.startswith("gru_l"):  # decoder GRU cells
                    cell = f"{prefix}.gru.{name[5:]}"
                    for gate in ("ih", "hh"):
                        sd[f"{cell}.weight_{gate}"] = _t(np.asarray(sub[gate]["kernel"]).T)
                        sd[f"{cell}.bias_{gate}"] = _t(sub[gate]["bias"])
                elif name.startswith("l") and name.endswith(("_fwd", "_bwd")):  # nn.GRU
                    _gru(sd, prefix, {name: sub})
                else:
                    walk(f"{prefix}.{name}", sub)

    for net in ("speech", "style", "decoder"):
        walk(net, _unwrap(params[net]))
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


def read_reference_state_dict(path: str) -> StateDict:
    """A reference-layout `.pt` (bare state_dict or {'model_state_dict': …})
    → its state_dict on the CPU, `clip_model.*` left out. `weights_only=True`:
    a malicious checkpoint cannot run code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v for k, v in sd.items() if not k.startswith("clip_model.")}


def _load_reference(path: Union[str, Mapping[str, torch.Tensor]], model: torch.nn.Module,
                    device: Union[str, torch.device]) -> torch.nn.Module:
    """A reference-layout `.pt` (or its `read_reference_state_dict`) into
    `model`, which moves to `device` in eval mode. The buffers the port
    recomputes are not read."""
    dev = resolve_device(device)
    sd = read_reference_state_dict(path) if isinstance(path, str) else path
    _load_into(model, sd, path if isinstance(path, str) else "state_dict")
    return model.to(dev).eval()


def load_reference_mdm(path: Union[str, Mapping[str, torch.Tensor]],
                       cfg: MDMConfig = MDMConfig(),
                       device: Union[str, torch.device] = "cuda") -> MDM:
    """A reference-layout ZEGGS MDM `.pt` (or its state_dict) → an eval-mode
    `MDM` on `device`."""
    return _load_reference(path, MDM(cfg), device)


def load_reference_mdm_plus(path: Union[str, Mapping[str, torch.Tensor]],
                            cfg: MDMPlusConfig = MDMPlusConfig(),
                            device: Union[str, torch.device] = "cuda") -> MDMPlus:
    """A reference-layout BEAT/TWH MDM `.pt` (the counterpart of the JAX
    `convert_mdm_beat_twh`), or the port's own `model.pt` of one, or its
    state_dict → an eval-mode `MDMPlus` on `device`."""
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
    if dtype == torch.bfloat16:
        sd = bf16_cast(sd)
    model = WavLM(cfg)
    _load_into(model, sd, path)
    return cfg, model.to(dev).eval()
