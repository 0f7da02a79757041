"""Operations and bytes of the work, computed from shapes and frozen with the
benchmark, so a roofline or MFU share reads the same work whatever computes it.

Conventions (stated in PERF.md):

* operations are the algorithm's multiply-adds counted once, as 2 FLOPs
  each, over the matrix products of the layer or model (softmax, norms,
  activations and element-wise ops are left out: they are a fraction of a
  percent here and not what the tensor cores do);
* bytes: each input read once and each output written once, float32, the
  weights included; q = k = v of the local attention is one input;
* peaks (`PEAKS`): an H100 SXM's dense rates. The float32 configurations
  are held against TF32, the highest rate at which the card takes float32
  operands, so no correct float32 implementation reads above 100%.
"""
from __future__ import annotations

PEAKS = {
    "tf32_flops": 495e12,   # dense TF32 tensor-core rate, H100 SXM
    "bf16_flops": 989e12,   # dense bf16 tensor-core rate, H100 SXM
    "hbm_bytes": 3.35e12,   # HBM3 bytes a second, H100 SXM
}
F32 = 4


def least_seconds(flops: float, nbytes: float, precision: str = "tf32") -> float:
    """The roofline's least time: the larger of the operations over the
    precision's peak and the bytes over the memory's."""
    return max(flops / PEAKS[precision + "_flops"], nbytes / PEAKS["hbm_bytes"])


def linear(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def encoder_layer(B: int, T: int, D: int, H: int, F: int) -> tuple:
    """(FLOPs, bytes) of one post-norm encoder layer over (B, T, D), H heads,
    feed-forward width F: QKV, scores, probabilities × V, out-projection, FFN."""
    rows = B * T
    flops = (linear(rows, D, 3 * D) + 2 * 2 * B * T * T * D + linear(rows, D, D)
             + linear(rows, D, F) + linear(rows, F, D))
    weights = 3 * D * D + 3 * D + D * D + D + D * F + F + F * D + D + 4 * D
    return flops, F32 * (2 * rows * D + weights)


def local_attention(B: int, H: int, N: int, hd: int, w: int) -> tuple:
    """(FLOPs, bytes) of the windowed causal attention, q = k = v (B, H, N, hd):
    each query against the keys it may see (the whole previous window but for
    window 0, and its own window up to itself), scores and values; the
    boolean key mask and the output included."""
    W = N // w
    pairs = W * w * (w + 1) // 2 + (W - 1) * w * w
    return 2 * 2 * B * H * hd * pairs, F32 * (2 * B * H * N * hd) + B * N


def wavlm_window(cfg: dict, samples: int) -> int:
    """FLOPs of WavLM over one window of `samples` raw samples."""
    n, cin, flops = samples, 1, 0
    for dim, k, stride in cfg["conv_feature_layers"]:
        n = (n - k) // stride + 1
        flops += 2 * n * dim * cin * k
        cin = dim
    D, Fh, H = cfg["encoder_embed_dim"], cfg["encoder_ffn_embed_dim"], cfg["encoder_attention_heads"]
    flops += linear(n, cin, D) + 2 * n * D * (D // cfg["conv_pos_groups"]) * cfg["conv_pos"]
    per_layer = (4 * linear(n, D, D) + 2 * 2 * n * n * D + linear(n * H, D // H, 8)
                 + linear(n, D, Fh) + linear(n, Fh, D))
    return flops + cfg["encoder_layers"] * per_layer


def trunk(B: int, cfg: dict) -> int:
    """FLOPs of the local block's attention and the encoder layers over B rows."""
    T, D = cfg["n_poses"], cfg["latent_dim"]
    la, _ = local_attention(B, cfg["local_heads"], T, D // cfg["local_heads"], cfg["window_size"])
    el, _ = encoder_layer(B, T + 1, D, cfg["num_heads"], cfg["ff_size"])
    return la + cfg["num_layers"] * el


def zeggs_call(B: int, cfg: dict) -> int:
    """FLOPs of one ZEGGS denoiser call (cross_local_attention3_style1) over B rows."""
    T, D, C, A = cfg["n_poses"], cfg["latent_dim"], cfg["njoints"], cfg["audio_feat_dim"]
    return (2 * linear(B, D, D) + linear(B, cfg["style_dim_in"], cfg["style_dim"])
            + linear(B, C * cfg["n_seed"], D - cfg["style_dim"])
            + linear(B * T, cfg["audio_in_dim"], A) + linear(B * T, C, D)
            + linear(B * T, 2 * D + A, D) + trunk(B, cfg) + linear(B * T, D, C))


def twh_call(B: int, cfg: dict) -> int:
    """FLOPs of one TWH denoiser call (cross_local_attention4_style1) over B rows."""
    T, D, C, A, ns = (cfg["n_poses"], cfg["latent_dim"], cfg["njoints"], cfg["audio_feat_dim"],
                      cfg["n_seed"])
    return (2 * linear(B, D, D) + linear(B, cfg["style_dim_in"], D) + linear(B * ns, C, A)
            + linear(B * (T - ns), cfg["source_audio_dim"], A) + linear(B * T, C, D)
            + linear(B * T, 2 * D + A, D) + trunk(B, cfg) + linear(B * T, D, C))
