"""Wrapper of the post-norm encoder-layer CUDA kernel (`csrc/encoder_layer.cu`,
the port of `ops/encoder_layer_pallas.py`).

A CPU tensor goes to the plain PyTorch layer
(`models/transformer.py::TorchEncoderLayer.forward`); a CUDA tensor
launches the kernel or raises. One launch is one layer: a single host
call that issues the layer's seven CUDA grids on the current stream.
`launches` counts those layer launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.transformer import ACTIVATIONS, TorchEncoderLayer
from . import build

ACT_CODES = {"gelu": 1, "gelu_tanh": 2, "relu": 3}
SMEM_LIMIT = 227 * 1024

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("encoder_layer")
        lib.dsg_encoder_layer.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                                          + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.dsg_encoder_layer.restype = ctypes.c_int
        lib.dsg_encoder_layer_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.dsg_encoder_layer_attention_smem_bytes.restype = ctypes.c_size_t
        lib.dsg_encoder_layer_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.dsg_encoder_layer_workspace_floats.restype = ctypes.c_size_t
        lib.dsg_encoder_layer_max_width.argtypes = []
        lib.dsg_encoder_layer_max_width.restype = ctypes.c_int
        _lib = lib
    return _lib


def layer_weights(layer: TorchEncoderLayer):
    """The layer's 12 parameter tensors in the kernel's argument order."""
    a = layer.self_attn
    return (a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias)


def encoder_layer(x: torch.Tensor, layer: TorchEncoderLayer) -> torch.Tensor:
    """x: (B, T, D) float32 → one post-norm encoder layer."""
    if x.device.type == "cpu":
        return layer(x)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_layer: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("encoder_layer: x must be a contiguous float32 (B, T, D) tensor")
    if layer.activation not in ACTIVATIONS:
        raise ValueError(f"encoder_layer: unsupported activation {layer.activation!r}")
    B, T, D = x.shape
    H = layer.self_attn.num_heads
    F = layer.linear1.out_features
    weights = layer_weights(layer)
    for w in weights:
        if w.device != x.device or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError("encoder_layer: weights must be contiguous float32 on x's device")
    if D != layer.self_attn.embed_dim or D % H:
        raise ValueError(f"encoder_layer: D={D} does not match the layer")
    if (D // H) % 4 or F % 4:
        raise ValueError(f"encoder_layer: head dim {D // H} and F={F} must be multiples of 4")
    if any(t.data_ptr() % 16 for t in (x,) + weights):
        raise ValueError("encoder_layer: x and the weights must be 16-byte aligned")
    lib = _library()
    if D > lib.dsg_encoder_layer_max_width():
        raise ValueError(f"encoder_layer: D={D} above {lib.dsg_encoder_layer_max_width()}")
    if lib.dsg_encoder_layer_attention_smem_bytes(T, D, H) > SMEM_LIMIT:
        raise ValueError(f"encoder_layer: T={T}, D={D}, H={H} exceed the shared-memory limit")

    work = torch.empty(lib.dsg_encoder_layer_workspace_floats(B, T, D, F), device=x.device,
                       dtype=torch.float32)
    out = torch.empty_like(x)
    err = lib.dsg_encoder_layer(
        x.data_ptr(), *(w.data_ptr() for w in weights), work.data_ptr(), out.data_ptr(),
        B, T, D, H, F, ACT_CODES[layer.activation], (D // H) ** -0.5, layer.norm1.eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"encoder_layer kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
