"""Wrapper of the post-norm encoder-layer CUDA kernel (`csrc/encoder_layer.cu`),
the port of `diffusestylegesture_tpu/ops/encoder_layer_pallas.py::encoder_layer_pallas`.

A CPU tensor goes to the plain PyTorch layer
(`models/transformer.py::TorchEncoderLayer.forward`); a CUDA tensor
launches the kernel or raises. The kernel has no backward: on a CUDA
tensor the wrapper raises when autograd is on and x or a weight of the
layer requires grad, since its result would silently carry no gradient
(training runs `impl="plain"`); serving calls it under `no_grad` or
`inference_mode`. One launch is one layer: a single host call that issues
the layer's seven CUDA grids on the current stream. `launches` counts the
float32 (3xTF32) layer launches, `launches_bf16` those in the `mxu_bf16`
operand mode, `launches_planes` the float32 GEMM grids (four a layer at
most) that ran on weight planes, and `splits` the layers whose planes were
built.

The design (the source's header says more). Every product is a Hopper
`wgmma` (3xTF32 in float32 mode, bf16 operands in `mxu_bf16` mode) on tiles
that TMA brings into shared memory, fed by one producer warp. Five steps,
seven grids a layer: QKV; attention (64 queries a block, keys in tiles of 64
/ 32 / 16 by head dim with an online softmax); out-proj, then residual +
LN1; FF1; FF2, then residual + LN2. Every GEMM grid is one kernel: row x
column tiles with K split over a cluster of up to 8 blocks, whose partials
go straight into the shared memory of the block that owns their rows and
are summed there in a fixed order (repeat calls are bitwise equal); the
LayerNorms run one warp a row. In float32 mode a GEMM grid splits its
activation operand in registers (3xTF32: big and small), and takes the
weight's big and small parts either from weight planes, split once per
weight version (`weight_planes`), or splits each weight tile in shared
memory as it lands; the plan picks per grid (`GridPlan.planes`). The bf16
mode rounds both tiles in shared memory. At B = 1 the bytes bound a layer
(1.0 µs at the ZEGGS shape on an H100): two 64-row tiles, so the GEMM grids
split K to spread over the SMs, and each grid issues and splits its weight
tiles before it waits for the grid before. At B ≥ 16 the operations do: row
tiles of 64 or 128 rows spanning the batch read each weight tile once a
tile, on weight planes, and the tiles and stages keep a grid's blocks on the
SMs at once.

Weight planes (float32 GEMM grids whose weight tile is read by many row
tiles): two float32 copies of each of the layer's four weight matrices, big
(the top 19 bits, a TF32 value) and small (the rest, exact), made by the
source's split kernel at an eager call and kept on the layer, keyed by the
`(data_ptr, _version)` of the parameters they come from. An eager call after
an in-place weight update refreshes them in place (same storage, so CUDA
graphs captured earlier read the new planes); a call that would build or
refresh them while the stream captures raises. A graph replayed after a
weight update with no eager call in between reads the old planes.

`plan(B, T, D, H, F, mxu_bf16)` picks every step's tiles from the shape and
the card's SM count, in plain Python (the CPU tests check every shape the
port runs), once a shape; the CUDA source checks the plan against its own
needs and refuses one it cannot run. Head dims above 256 are refused.
Measured times: PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700 W: 0.032
ms a layer at (1, 89, 256) in float32, 0.067 at (16, 89, 256), 0.91 at
(300, 89, 256); scripts/encoder_layer_timing.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..models.transformer import ACTIVATIONS, TorchEncoderLayer
from . import build

ACT_CODES = {"gelu": 1, "gelu_tanh": 2, "relu": 3}
SMEM_LIMIT = 227 * 1024     # dynamic shared memory a block can use on an H100
SMEM_RESERVE = 1024 + 256   # alignment slack and the mbarriers, in every grid
MAX_WIDTH = 1024
MAX_HEAD_DIM = 256
MAX_CLUSTER = 8             # portable cluster size
MAX_STAGES = 10            # three mbarriers a stage in the reserved bytes
# a float32 GEMM grid reads weight planes where at least this many row tiles
# read each weight tile; fewer split the weight tiles in shared memory (on an
# H100, scripts/encoder_layer_timing.py --w-paths: the planes lose 0.5-2.1 us a
# layer at 2, 3 and 5 row tiles and win 2.1-42 us from 6 on; PERF.md)
PLANES_MIN_ROW_TILES = 6
SMS = 132                   # H100 SXM: the plan's SM count where no card is visible
SM_SMEM = 228 * 1024        # shared memory of an SM, for the blocks it holds at once
BLOCK_SMEM_RESERVED = 1024  # the system's share of it a block
BLOCK_OVERHEAD = 64 * 64 * 64  # a block's (and a stage's) fixed cost in the plan, as multiply-adds
REDUCE_WEIGHT = 4              # a received partial value's cost, as multiply-adds
# the layer's steps: the GEMM or attention grid of each (steps 3 and 5 also launch a
# LayerNorm grid after their GEMM grid)
GRIDS = ("qkv", "attention", "out_ln1", "ff1", "ff2_ln2")
GRIDS_A_LAYER = 7
# K splits of the QKV and FF1 GEMMs, and of the out-proj and FF2 GEMMs
# (N = D, the narrowest: at B = 1 only splitting K by 8 spreads them over the SMs)
GEMM_SPLITS = {"qkv": (1, 2, 4), "out_ln1": (1, 2, 4, 8), "ff1": (1, 2, 4),
               "ff2_ln2": (1, 2, 4, 8)}
PLAN_INTS = 7               # a step's plan as the CUDA source takes it (GridPlan.ints)
GEMM_TILES = ((2, 2), (1, 2), (1, 1))   # (consumer warpgroups, n64 blocks): 128 x 128 .. 64 x 64

# dsg_encoder_layer(which, x, 12 weights, planes, work, out, B, T, D, H, F, act, bf16, scale,
#                   eps, plan, stream)
LAYER_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
# dsg_encoder_layer_split(w_in, w_out, w1, w2, planes, D, F, stream)
SPLIT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

launches = 0
launches_bf16 = 0
launches_planes = 0
splits = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("encoder_layer")
        lib.dsg_encoder_layer.argtypes = LAYER_ARGTYPES
        lib.dsg_encoder_layer.restype = ctypes.c_int
        lib.dsg_encoder_layer_grid_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.dsg_encoder_layer_grid_smem.restype = ctypes.c_size_t
        lib.dsg_encoder_layer_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.dsg_encoder_layer_workspace_floats.restype = ctypes.c_size_t
        lib.dsg_encoder_layer_plane_floats.argtypes = [ctypes.c_int] * 2
        lib.dsg_encoder_layer_plane_floats.restype = ctypes.c_size_t
        lib.dsg_encoder_layer_split.argtypes = SPLIT_ARGTYPES
        lib.dsg_encoder_layer_split.restype = ctypes.c_int
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """One step's GEMM or attention grid: `nc` consumer warpgroups (64 nc rows
    a block), `nb` n64 blocks (64 nb columns, one wgmma of that width a
    k-step), `ck` K slices (a cluster of ck blocks), `stages` of the TMA ring
    (attention: TMA buffers of K/V tiles), `kt` keys a tile, the blocks and
    shared-memory bytes, `overlay`: whether a split grid's receive buffer
    lies over its ring (one more cluster barrier, less shared memory) rather
    than beside it, and `planes`: whether a float32 GEMM grid reads the
    weight planes rather than splitting its weight tiles."""
    name: str
    nc: int
    nb: int
    ck: int
    stages: int
    kt: int
    blocks: int
    smem: int
    overlay: int = 0
    planes: int = 0

    def ints(self):
        return [self.nc, self.nb, self.ck, self.stages, self.kt, self.overlay, self.planes]

    def describe(self) -> str:
        tile = f"{64 * self.nc}x{64 * self.nb}"
        if self.name == "attention":
            return (f"{self.name} 64 queries x {self.kt} keys, {self.nc} warpgroup(s) x "
                    f"{self.stages} buffer(s)")
        if self.ck > 1:
            tile += f" cluster of {self.ck}"
        return (f"{self.name} {tile} {self.stages} stages"
                + (" on weight planes" if self.planes else "")
                + (" + LayerNorm grid" if self.name in ("out_ln1", "ff2_ln2") else ""))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemm_stage(nc: int, nb: int, bf16: bool) -> int:
    """Bytes of one ring stage: raw A and W rows of 32 f32, then W's small
    part (f32; A is split in registers) or bf16 copies of both."""
    return 64 * (nc + nb) * 192 if bf16 else 64 * (128 * nc + 256 * nb)


def _receive(nc: int, nb: int, ck: int) -> int:
    """Bytes of a split block's receive buffer: the ck partials of the rows it
    owns (64 nc / ck of them), f32, rows padded by 4."""
    return ck * _cdiv(64 * nc, ck) * (64 * nb + 4) * 4


def _per_sm(smem: int) -> int:
    """Blocks of this much dynamic shared memory one SM holds at once."""
    return SM_SMEM // (smem + BLOCK_SMEM_RESERVED)


def _cost(blocks: int, rows: int, cols: int, k: int, received: int, sms: int) -> int:
    """The busiest SM's share of a grid, in multiply-adds: ceil(blocks / SMs)
    blocks of rows x cols x k each, plus a fixed cost a block (its first
    loads and the pipeline's fill) and its share of a split grid's reduction
    (`received` partial values summed, REDUCE_WEIGHT each); in a grid of no
    more blocks than SMs, where no other block hides it, a latency cost a
    stage of 32 k too."""
    latency = _cdiv(k, 32) * BLOCK_OVERHEAD if blocks <= sms else 0
    work = rows * cols * k + BLOCK_OVERHEAD + REDUCE_WEIGHT * received
    return _cdiv(blocks, sms) * work + latency


def _gemm(name: str, M: int, N: int, K: int, bf16: bool, sms: int,
          planes: Optional[bool] = None) -> GridPlan:
    """The GEMM grid of step `name`: for each tile, K is split over a cluster
    (the most of GEMM_SPLITS[name]) while the blocks still fit three a SM and
    each keeps two stages of K, so that at B = 1 and 2 a grid of a few dozen
    tiles spreads over the SMs. Of the tiles whose ring fits, the one whose
    busiest SM does the least, then the smaller cluster, then fewer blocks;
    with the most ring stages (two at least, or every chunk) that keep all its
    blocks on the SMs at once, or as many a SM as two stages allow. A split
    grid of more blocks than SMs lays its receive buffer over its ring (more
    blocks a SM); one of fewer keeps it beside (one cluster barrier) unless
    only the overlay leaves room for a ring. In float32 mode the grid reads
    the weight planes where PLANES_MIN_ROW_TILES row tiles or more read each
    weight tile (`planes`, where given, decides instead); both ways take the
    same shared memory."""
    best = None
    for nc, nb in GEMM_TILES:
        tiles = _cdiv(M, 64 * nc) * _cdiv(N, 64 * nb)
        ck = max(s for s in GEMM_SPLITS[name] if s == 1 or (tiles * s <= 3 * sms and K >= 64 * s))
        kl = _cdiv(_cdiv(K, ck), 32) * 32
        if _cdiv(K, kl) != ck:
            continue  # an empty K slice
        blocks = tiles * ck
        stage, chunks = _gemm_stage(nc, nb, bf16), _cdiv(kl, 32)
        recv = _receive(nc, nb, ck) if ck > 1 else 0
        for overlay in ((1,) if blocks > sms else (0, 1)) if recv else (0,):
            size = (lambda s, r=recv, o=overlay, st=stage:
                    SMEM_RESERVE + (max(s * st, r) if o else s * st + r))
            top = min(chunks, MAX_STAGES)
            while top and size(top) > SMEM_LIMIT:
                top -= 1
            if top >= min(2, chunks):
                break
        else:
            continue  # no ring fits
        received = ck * 64 * nc * 64 * nb if ck > 1 else 0
        key = (_cost(blocks, 64 * nc, 64 * nb, kl, received, sms), ck, blocks)
        if best is None or key < best[0]:
            best = (key, nc, nb, ck, blocks, chunks, top, overlay, size)
    _, nc, nb, ck, blocks, chunks, top, overlay, size = best
    # every block on an SM at once where the stages allow it, else as many a SM as they do
    for want in range(_cdiv(blocks, sms), 0, -1):
        stages = next((s for s in range(top, min(2, chunks) - 1, -1)
                       if _per_sm(size(s)) >= want), None)
        if stages is not None:
            break
    if planes is None:
        planes = _cdiv(M, 64 * nc) >= PLANES_MIN_ROW_TILES
    return GridPlan(name, nc, nb, ck, stages, 0, blocks, size(stages), overlay,
                    int(planes and not bf16))


def attention_nb(hd: int) -> int:
    return 1 if hd <= 64 else 2 if hd <= 128 else 4


def attention_region(hd: int, bf16: bool, nraw: int) -> int:
    """One consumer warpgroup's part of the attention grid's shared memory: nraw
    TMA buffers of a K and a V tile, the converted K and V^T."""
    nb, hc, kt = attention_nb(hd), _cdiv(hd, 32), key_tile(hd, 1)
    op = hc * kt * 64 + 64 * nb * kt * 2 if bf16 else hc * kt * 256 + 64 * nb * kt * 8
    return nraw * 2 * hc * kt * 128 + op


def attention_bytes(hd: int, bf16: bool, nraw: int, nw: int) -> int:
    """Q (raw and small / bf16), then nw warpgroups' parts (as the source's
    attention_bytes)."""
    return _cdiv(hd, 32) * 8192 * (3 if bf16 else 4) // 2 + nw * attention_region(hd, bf16, nraw)


def _attention(B: int, T: int, D: int, H: int, bf16: bool, sms: int) -> GridPlan:
    """One block a (batch, head, 64 queries); its key tiles go to two consumer
    warpgroups (each a running max, sum and O over half of them, merged at
    the end) where the grid fills no more than half the SMs, there are two
    tiles at least, the head dim is 128 at most and both warpgroups' buffers
    fit, the second's large enough to hand its O over; TMA buffers: two a
    warpgroup where they fit, else one."""
    hd = D // H
    blocks, tiles = B * H * _cdiv(T, 64), _cdiv(T, key_tile(hd, 1))
    handoff = 128 * (attention_nb(hd) * 32 + 4) * 4
    two = 2 * blocks <= sms and tiles >= 2 and attention_nb(hd) <= 2
    for nw in ((2, 1) if two else (1,)):
        for nraw in (2, 1):
            size = SMEM_RESERVE + attention_bytes(hd, bf16, nraw, nw)
            if size <= SMEM_LIMIT and (nw == 1 or attention_region(hd, bf16, nraw) >= handoff):
                return GridPlan("attention", nw, attention_nb(hd), 1, nraw, key_tile(hd, 1),
                                blocks, size)
    raise AssertionError("the attention grid fits one warpgroup at head dims up to 256")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(B: int, T: int, D: int, H: int, F: int, mxu_bf16: bool = False) -> Tuple[GridPlan, ...]:
    """The five steps' tiles at this shape, for the current CUDA device's SM
    count (SMS where no card is visible). Raises ValueError for a shape the
    kernel does not take (head dim above 256, D above 1024, a width not a
    multiple of 4)."""
    sms = sm_count(torch.cuda.current_device()) if torch.cuda.is_available() else SMS
    return _plan(B, T, D, H, F, bool(mxu_bf16), sms)[0]


@functools.lru_cache(maxsize=256)
def _plan(B: int, T: int, D: int, H: int, F: int, mxu_bf16: bool, sms: int,
          planes: Optional[bool] = None):
    """(grids, their ints as the CUDA source takes them) at this shape on a
    card of `sms` SMs; each path runs a few shapes, so a call looks its plan up.
    `planes` True / False puts every float32 GEMM grid on weight planes or on
    the split in shared memory (the tests and the timing script compare the
    two); None lets the shape decide."""
    if D % H or (D // H) % 4 or F % 4 or D % 4:
        raise ValueError(f"encoder_layer: head dim {D / H} and F={F} must be multiples of 4")
    if D > MAX_WIDTH:
        raise ValueError(f"encoder_layer: D={D} above {MAX_WIDTH}")
    if D // H > MAX_HEAD_DIM:
        raise ValueError(f"encoder_layer: head dim {D // H} needs more shared memory than a "
                         f"block has ({SMEM_LIMIT} bytes); the kernel takes up to {MAX_HEAD_DIM}")
    M = B * T
    grids = (_gemm("qkv", M, 3 * D, D, mxu_bf16, sms, planes),
             _attention(B, T, D, H, mxu_bf16, sms),
             _gemm("out_ln1", M, D, D, mxu_bf16, sms, planes),
             _gemm("ff1", M, F, D, mxu_bf16, sms, planes),
             _gemm("ff2_ln2", M, D, F, mxu_bf16, sms, planes))
    assert all(g.smem <= SMEM_LIMIT for g in grids), grids
    return grids, plan_ints(grids)


def plan_ints(grids) -> ctypes.Array:
    return (ctypes.c_int * (PLAN_INTS * len(grids)))(*[v for g in grids for v in g.ints()])


def describe_plan(B: int, T: int, D: int, H: int, F: int, mxu_bf16: bool = False) -> dict:
    """Row tile (64 a consumer warpgroup; the attention grid's block holds 64
    queries and splits its key tiles over its warpgroups), n-tile, cluster,
    stages and blocks of each step's GEMM or attention grid, and grids a
    layer."""
    grids = plan(B, T, D, H, F, mxu_bf16)
    return dict(grids_a_layer=GRIDS_A_LAYER, **{g.name: dict(
        rows=64 * g.nc, cols=64 * g.nb, cluster=g.ck, stages=g.stages, key_tile=g.kt,
        blocks=g.blocks, smem=g.smem, planes=g.planes) for g in grids})


def key_tile(D: int, H: int) -> int:
    """Keys a tile of the attention grid at width D over H heads: 64, 32 or 16
    at head dims up to 64, 128 and 256, whatever T; -1 when the kernel takes
    no such head dim."""
    hd = D // H
    return {1: 64, 2: 32, 4: 16}[attention_nb(hd)] if D % H == 0 and hd <= MAX_HEAD_DIM else -1


def layer_weights(layer: TorchEncoderLayer):
    """The layer's 12 parameter tensors in the kernel's argument order; a split
    q / k / v layout gives its packed concatenation, made once
    (`TorchMultiheadAttention.packed_in_proj`)."""
    a = layer.self_attn
    in_w, in_b = a.packed_in_proj()
    return (in_w, in_b, a.out_proj.weight, a.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias)


def _plane_key(layer: TorchEncoderLayer) -> tuple:
    """(data_ptr, _version) of every parameter the weight planes come from (an
    inference tensor keeps no version: its data_ptr alone)."""
    a = layer.self_attn
    ins = [w for w, _ in a.qkv_parts()] if a.split_qkv else [a.in_proj_weight]
    return tuple((t.data_ptr(), -1 if t.is_inference() else t._version)
                 for t in ins + [a.out_proj.weight, layer.linear1.weight, layer.linear2.weight])


def weight_planes(layer: TorchEncoderLayer, weights, device: torch.device) -> torch.Tensor:
    """The layer's weight planes on `device`, built or refreshed in place (on
    the current stream) when its weights changed since they were last split.
    Raises when that would happen while the stream captures a CUDA graph."""
    cache = layer.__dict__.setdefault("_weight_planes", {})
    key = _plane_key(layer)
    held = cache.get(device.index)
    if held is not None and held[0] == key:
        return held[1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "encoder_layer: the layer's weight planes would be split inside a CUDA graph "
            "capture; run the layer eagerly once (the capture's warm-up) after its weights change")
    lib = _library()
    D, F = layer.self_attn.embed_dim, layer.linear1.out_features
    planes = held[1] if held is not None else torch.empty(
        lib.dsg_encoder_layer_plane_floats(D, F), device=device, dtype=torch.float32)
    in_w, _, out_w, _, _, _, w1, _, w2 = weights[:9]
    with torch.cuda.device(device):
        err = lib.dsg_encoder_layer_split(
            in_w.data_ptr(), out_w.data_ptr(), w1.data_ptr(), w2.data_ptr(), planes.data_ptr(),
            D, F, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"encoder_layer weight split failed: CUDA error {err}")
    global splits
    splits += 1
    cache[device.index] = (key, planes)
    return planes


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
    if D != layer.self_attn.embed_dim or D % H:
        raise ValueError(f"encoder_layer: D={D} does not match the layer")
    return _run(x, layer, mxu_bf16, *_plan(B, T, D, H, F, bool(mxu_bf16), sm_count(x.device.index)))


def _run(x: torch.Tensor, layer: TorchEncoderLayer, mxu_bf16: bool, grids, ints) -> torch.Tensor:
    """The layer on the card under the plan `grids` (`ints` as the source takes them)."""
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
    if any(t.data_ptr() % 16 for t in (x,) + weights):
        raise ValueError("encoder_layer: x and the weights must be 16-byte aligned")
    on_planes = sum(g.planes for g in grids)
    planes = weight_planes(layer, weights, x.device).data_ptr() if on_planes else None
    lib = _library()
    work = torch.empty(lib.dsg_encoder_layer_workspace_floats(B, T, D, F), device=x.device,
                       dtype=torch.float32)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the kernel opts in and launches on x's card
        err = lib.dsg_encoder_layer(
            0, x.data_ptr(), *(w.data_ptr() for w in weights), planes, work.data_ptr(),
            out.data_ptr(), B, T, D, H, F, ACT_CODES[layer.activation], int(mxu_bf16),
            (D // H) ** -0.5, layer.norm1.eps, ctypes.addressof(ints),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"encoder_layer kernel launch failed: CUDA error {err}")
    global launches, launches_bf16, launches_planes
    if mxu_bf16:
        launches_bf16 += 1
    else:
        launches += 1
    launches_planes += on_planes
    return out
