"""Wrapper of the post-norm encoder-layer CUDA kernel (`csrc/encoder_layer.cu`,
the port of `ops/encoder_layer_pallas.py`).

A CPU tensor goes to the plain PyTorch layer
(`models/transformer.py::TorchEncoderLayer.forward`); a CUDA tensor
launches the kernel or raises. The kernel has no backward: on a CUDA
tensor the wrapper raises when autograd is on and x or a weight of the
layer requires grad, since its result would silently carry no gradient
(training runs `impl="plain"`); serving calls it under `no_grad` or
`inference_mode`. One launch is one layer: a single host
call that issues the layer's four CUDA grids on the current stream.
`launches` counts the float32 (3xTF32) layer launches, `launches_bf16`
those in the `mxu_bf16` operand mode.

The attention grid holds one head's keys and values in shared memory whole
where they fit (every ZEGGS / BEAT / TWH shape), and streams them in key
tiles with an online softmax where they do not (T > 176 at head dim 128, as
HumanML3D's T = 197; T > 336 at head dim 64). `key_tile(T, D, H)` says which
one a shape takes.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.transformer import ACTIVATIONS, TorchEncoderLayer
from . import build

ACT_CODES = {"gelu": 1, "gelu_tanh": 2, "relu": 3}
SMEM_LIMIT = 227 * 1024
MAX_WIDTH = 1024

# dsg_encoder_layer(which, x, 12 weights, work, out, B, T, D, H, F, act, bf16, scale, eps, stream)
LAYER_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

launches = 0
launches_bf16 = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("encoder_layer")
        lib.dsg_encoder_layer.argtypes = LAYER_ARGTYPES
        lib.dsg_encoder_layer.restype = ctypes.c_int
        lib.dsg_encoder_layer_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.dsg_encoder_layer_smem_bytes.restype = ctypes.c_size_t
        lib.dsg_encoder_layer_key_tile.argtypes = [ctypes.c_int] * 3
        lib.dsg_encoder_layer_key_tile.restype = ctypes.c_int
        lib.dsg_encoder_layer_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.dsg_encoder_layer_workspace_floats.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def layer_weights(layer: TorchEncoderLayer):
    """The layer's 12 parameter tensors in the kernel's argument order; a split
    q / k / v layout gives its packed concatenation, made once
    (`TorchMultiheadAttention.packed_in_proj`)."""
    a = layer.self_attn
    in_w, in_b = a.packed_in_proj()
    return (in_w, in_b, a.out_proj.weight, a.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias)


def key_tile(T: int, D: int, H: int) -> int:
    """Keys per tile of the attention grid the kernel runs at this shape: 0 for
    the whole-row grid, -1 when neither fits (builds the library)."""
    return _library().dsg_encoder_layer_key_tile(T, D, H)


def encoder_layer(x: torch.Tensor, layer: TorchEncoderLayer,
                  mxu_bf16: bool = False) -> torch.Tensor:
    """x: (B, T, D) float32 → one post-norm encoder layer. mxu_bf16=True rounds
    the matmul operands to bf16 and sums in float32, as the Pallas kernel's
    mode of that name; the default is float32 throughout."""
    if x.device.type == "cpu":
        return layer(x, mxu_bf16=mxu_bf16)
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + weights):
        raise RuntimeError(
            "encoder_layer: the CUDA kernel has no backward, and x or the layer's weights "
            "require grad; training uses impl='plain' (or call under torch.no_grad())")
    for w in weights:
        if w.device != x.device or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError("encoder_layer: weights must be contiguous float32 on x's device")
    if D != layer.self_attn.embed_dim or D % H:
        raise ValueError(f"encoder_layer: D={D} does not match the layer")
    if (D // H) % 4 or F % 4:
        raise ValueError(f"encoder_layer: head dim {D // H} and F={F} must be multiples of 4")
    if any(t.data_ptr() % 16 for t in (x,) + weights):
        raise ValueError("encoder_layer: x and the weights must be 16-byte aligned")
    if D > MAX_WIDTH:
        raise ValueError(f"encoder_layer: D={D} above {MAX_WIDTH}")
    lib = _library()
    if lib.dsg_encoder_layer_smem_bytes(T, D, H, F) > SMEM_LIMIT:
        raise ValueError(f"encoder_layer: T={T}, D={D}, H={H}, F={F} need more shared memory "
                         f"than a block has ({SMEM_LIMIT} bytes)")

    work = torch.empty(lib.dsg_encoder_layer_workspace_floats(B, T, D, F), device=x.device,
                       dtype=torch.float32)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the kernel opts in and launches on x's card
        err = lib.dsg_encoder_layer(
            0, x.data_ptr(), *(w.data_ptr() for w in weights), work.data_ptr(), out.data_ptr(),
            B, T, D, H, F, ACT_CODES[layer.activation], int(mxu_bf16), (D // H) ** -0.5,
            layer.norm1.eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"encoder_layer kernel launch failed: CUDA error {err}")
    global launches, launches_bf16
    if mxu_bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out
