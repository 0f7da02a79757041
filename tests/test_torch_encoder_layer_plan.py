"""Kernel B's plan (`ops/encoder_layer.py::plan`): the tiles of its five steps'
GEMM and attention grids, chosen in plain Python from the shape. At every
shape the port runs, each grid fits in a block's 227 KB of shared memory and
its tiles cover the rows, columns, K and keys; a shape the kernel cannot take
raises. CPU only: the
plan builds nothing (`tests/test_torch_isolation.py` holds the CUDA source
to the same byte counts on the card)."""
from __future__ import annotations

import pytest

from diffusestylegesture_torch.ops import encoder_layer as el

# (B, T, D, H, F): ZEGGS (89 tokens, 256), BEAT (151, 384) and TWH (151, 512) at
# B = 1, 2 (CFG), 16 (the server) and 300 (training batch, distillation);
# text-to-motion (512, 4 heads) at T = 121, 177, 197 x B = 2, 6, 64; T = 400 at
# D = 256; the widest layers the wrapper takes (D = 1024); the tests' small MDM
GESTURE = [(B, T, D, H, 1024) for T, D, H in ((89, 256, 4), (151, 384, 4), (151, 512, 4),
                                               (151, 512, 8))
           for B in (1, 2, 16, 300)]
T2M = [(B, T, 512, 4, 1024) for T in (121, 177, 197) for B in (2, 6, 64)]
PORT_SHAPES = GESTURE + T2M + [(2, 400, 256, 4, 1024), (1, 89, 1024, 4, 1024),
                               (1, 89, 1024, 8, 1024), (1, 89, 256, 1, 1024),
                               (2, 89, 128, 4, 256), (1, 337, 256, 4, 1024)]


@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PORT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_fits_and_covers(shape, mxu_bf16):
    B, T, D, H, F = shape
    M, hd = B * T, D // H
    grids = el.plan(B, T, D, H, F, mxu_bf16)
    assert [g.name for g in grids] == list(el.GRIDS)
    for g in grids:
        assert 0 < g.smem <= el.SMEM_LIMIT, g
    qkv, attn, ln1, ff1, ln2 = grids
    for g, N, K in ((qkv, 3 * D, D), (ff1, F, D), (ln1, D, D), (ln2, D, F)):
        kl = -(-(-(-K // g.ck)) // 32) * 32
        assert g.ck * kl >= K > (g.ck - 1) * kl                 # K slices cover K, none empty
        assert g.ck in el.GEMM_SPLITS[g.name] and g.ck <= el.MAX_CLUSTER
        assert 2 <= g.stages <= el.MAX_STAGES or g.stages >= -(-kl // 32)  # refills need two
        assert (g.nc, g.nb) in el.GEMM_TILES
        # row and column tiles cover M and N
        assert g.blocks == -(-M // (64 * g.nc)) * -(-N // (64 * g.nb)) * g.ck
        # a split grid of more blocks than SMs lays its receive buffer over its ring
        assert g.overlay in ((0, 1) if g.ck > 1 else (0,))
        assert g.overlay or g.ck == 1 or g.blocks <= el.SMS
        # float32 grids read the weight planes where enough row tiles share a weight tile
        assert g.planes == int(not mxu_bf16 and -(-M // (64 * g.nc)) >= el.PLANES_MIN_ROW_TILES)
        assert g.ints() == [g.nc, g.nb, g.ck, g.stages, g.kt, g.overlay, g.planes]
    assert attn.kt * -(-T // attn.kt) >= T and 64 * attn.nb >= hd
    assert attn.blocks == B * H * -(-T // 64)
    assert attn.stages in (1, 2) and attn.planes == 0
    # key tiles over two warpgroups only where the grid fills half the SMs at most
    assert attn.nc == 1 or (attn.nc == 2 and 2 * attn.blocks <= el.SMS and T > attn.kt
                            and attn.nb <= 2)
    assert el.key_tile(D, H) == attn.kt


def test_plan_takes_wide_tiles_at_large_batches_and_splits_k_at_small_ones():
    big = el.plan(300, 89, 256, 4, 1024)
    assert (big[0].nc, big[0].nb, big[0].ck) == (2, 2, 1)  # 128 x 128 QKV tiles, whole K
    assert all(g.blocks >= el.SMS for g in big)
    one = el.plan(1, 89, 256, 4, 1024)
    # two row tiles of 64 at B = 1: K split over a cluster so that a grid spreads over the SMs
    assert all(g.ck > 1 and g.blocks <= el.SMS for g in one if g.name != "attention")
    # FF2 (N = D = 256, K = 1024): K split by 8, 64 blocks rather than two row tiles' 16
    assert one[4].ck == el.MAX_CLUSTER and one[4].blocks == 64
    # a grid of more blocks than SMs keeps them all on the SMs at once where two
    # stages a block allow it (the server's batch: 276 and 368 blocks of 64 x 64)
    mid = el.plan(16, 89, 256, 4, 1024)
    assert all(el._per_sm(g.smem) * el.SMS >= g.blocks for g in mid)
    # head dims 64 / 128 / 256 take 64-, 32- and 16-key tiles
    assert [el.key_tile(D, 4) for D in (256, 512, 1024)] == [64, 32, 16]
    # GEMM grids split K while their blocks fit three a SM
    for B, T, D in ((1, 89, 256), (1, 151, 512), (16, 89, 256), (300, 89, 256)):
        for g in el.plan(B, T, D, 4, 1024):
            if g.name != "attention":
                assert g.ck == 1 or g.blocks <= 3 * el.SMS


def test_plan_reads_weight_planes_where_many_row_tiles_share_a_weight_tile():
    """Float32 GEMM grids on weight planes at the server's batch and the
    distillation teacher's (and the text-to-motion trunk's), splitting their
    weight tiles in shared memory at B = 1; never in bf16. Both ways at one
    shape (`_plan(..., planes=)`) take the same tiles, stages and shared memory."""
    def on_planes(B, T, D, bf16=False):
        return [g.planes for g in el.plan(B, T, D, 4, 1024, bf16) if g.name != "attention"]

    for B, T, D in ((16, 89, 256), (300, 89, 256), (6, 197, 512), (64, 197, 512)):
        assert on_planes(B, T, D) == [1, 1, 1, 1]
        assert on_planes(B, T, D, True) == [0, 0, 0, 0]
    for B, T, D in ((1, 89, 256), (1, 151, 512), (1, 151, 384)):
        assert on_planes(B, T, D) == [0, 0, 0, 0]
    for shape in PORT_SHAPES:
        grids = {way: el._plan(*shape, False, el.SMS, way)[0] for way in (True, False)}
        for a, b in zip(grids[True], grids[False]):
            assert (a.nc, a.nb, a.ck, a.stages, a.blocks, a.smem, a.overlay) == \
                (b.nc, b.nb, b.ck, b.stages, b.blocks, b.smem, b.overlay)
            assert (a.planes, b.planes) == ((0, 0) if a.name == "attention" else (1, 0))
    assert el.describe_plan(16, 89, 256, 4, 1024)["qkv"]["planes"] == 1


def test_plan_is_looked_up_once_a_shape():
    """A call of the wrapper looks its plan up: the same shape gives the same
    plan object, and describe_plan counts the LayerNorm grids of steps 3 and 5."""
    assert el.plan(1, 89, 256, 4, 1024) is el.plan(1, 89, 256, 4, 1024)
    assert el.plan(1, 89, 256, 4, 1024, True) is not el.plan(1, 89, 256, 4, 1024)
    described = el.describe_plan(1, 89, 256, 4, 1024)
    assert described["grids_a_layer"] == el.GRIDS_A_LAYER == 7
    assert described["ff2_ln2"]["cluster"] == el.MAX_CLUSTER


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="shared memory"):
        el.plan(1, 64, 1024, 1, 1024)  # head dim 1024
    with pytest.raises(ValueError, match="above 1024"):
        el.plan(1, 64, 2048, 16, 1024)
    with pytest.raises(ValueError, match="multiples of 4"):
        el.plan(1, 64, 256, 4, 1022)
    assert el.key_tile(1024, 1) == -1
