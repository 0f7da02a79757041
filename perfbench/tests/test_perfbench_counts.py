"""The frozen FLOP and byte counts against sums written out by hand."""
import pytest

from perfbench import counts


def test_encoder_layer_by_hand():
    B, T, D, H, F = 2, 3, 4, 2, 8
    qkv = 2 * B * T * D * 3 * D            # 576
    scores_and_values = 2 * (2 * B * H * T * T * (D // H))   # 288
    out = 2 * B * T * D * D                 # 192
    ffn = 2 * B * T * D * F * 2             # 768
    weights = 3 * D * D + 3 * D + D * D + D + 2 * D * F + F + D + 4 * D
    flops, nbytes = counts.encoder_layer(B, T, D, H, F)
    assert flops == qkv + scores_and_values + out + ffn == 1824
    assert nbytes == 4 * (2 * B * T * D + weights)


def test_local_attention_counts_only_visible_keys():
    # window 2 over 4 positions: window 0 sees 1 + 2 keys, window 1 sees 2 + (1 + 2)
    B, H, N, hd, w = 1, 1, 4, 3, 2
    pairs = (1 + 2) + (2 + 1 + 2 + 2)
    flops, nbytes = counts.local_attention(B, H, N, hd, w)
    assert flops == 2 * 2 * hd * pairs
    assert nbytes == 4 * 2 * N * hd + N


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(495e12, 0.0) == pytest.approx(1.0)
    assert counts.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(495e12, 6.7e12) == pytest.approx(2.0)


def test_wavlm_window_by_hand():
    cfg = {"conv_feature_layers": [[2, 4, 2]], "encoder_embed_dim": 4,
           "encoder_ffn_embed_dim": 8, "encoder_attention_heads": 2, "conv_pos": 2,
           "conv_pos_groups": 2, "encoder_layers": 1}
    n = (10 - 4) // 2 + 1                   # 4 frames
    conv = 2 * n * 2 * 1 * 4
    proj = 2 * n * 2 * 4
    pos = 2 * n * 4 * 2 * 2
    layer = 4 * 2 * n * 4 * 4 + 4 * n * n * 4 + 2 * n * 2 * 2 * 8 + 2 * 2 * n * 4 * 8
    assert counts.wavlm_window(cfg, 10) == conv + proj + pos + layer
