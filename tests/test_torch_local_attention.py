"""Windowed causal local attention of the PyTorch port vs the JAX package.

The port's plain version is held against the JAX XLA path and the Pallas
kernel (interpret mode) at atol 1e-5 (float32, same operation order up to
the einsum's summation over D ≤ 64 terms). The kernel's wrapper, given CPU
tensors, takes the plain version whatever the layout of q, k, v and `out`:
bitwise the packed-contiguous result. The CUDA kernel is held against the
plain version on a card in `test_torch_isolation.py`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusestylegesture_tpu.models.local_attention import local_attention as jax_local_attention
from diffusestylegesture_tpu.ops.local_attention_pallas import local_attention_pallas
from diffusestylegesture_torch.models.local_attention import local_attention, local_attention_plain
from diffusestylegesture_torch.ops import local_attention as ops_local_attention

from torch_port_utils import np32

# the last two are the BEAT and TWH denoisers' shapes (latent 384 and 512 over 8 heads)
CASES = [(22, 11, 32, 8), (30, 15, 48, 8), (88, 11, 32, 8), (150, 15, 48, 8), (150, 15, 64, 8)]
ATOL = 1e-5


def _inputs(n, d, heads, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b * heads, n, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, n), bool)
    if b > 1:
        mask[1, -7:] = False  # one partially masked batch row
    return q, k, v, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,w,d,heads", CASES)
def test_plain_matches_jax_xla_and_pallas(n, w, d, heads):
    q, k, v, mask = _inputs(n, d, heads)
    out = local_attention_plain(*_torch(q, k, v), w, torch.from_numpy(mask), heads=heads)
    ref = jax_local_attention(q, k, v, w, jnp.asarray(mask), heads=heads)
    with pltpu.force_tpu_interpret_mode():
        pal = local_attention_pallas(q, k, v, w, jnp.asarray(mask), heads=heads)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(np32(out), np.asarray(pal), atol=ATOL)


def test_no_mask_quirk_attends_window0_pads():
    q, k, v, _ = _inputs(22, 32, 8, b=1, seed=1)
    out = local_attention_plain(*_torch(q, k, v), 11, None, heads=8)
    ref = jax_local_attention(q, k, v, 11, None, heads=8)
    with pltpu.force_tpu_interpret_mode():
        pal = local_attention_pallas(q, k, v, 11, None, heads=8)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(np32(out), np.asarray(pal), atol=ATOL)
    # the -1.0 pad keys/values of window 0 are attended without a mask ...
    masked = local_attention_plain(*_torch(q, k, v), 11, torch.ones(1, 22, dtype=torch.bool),
                                   heads=8)
    assert np.abs(np32(out)[:, :11] - np32(masked)[:, :11]).max() > 1e-3
    # ... and windows past the first do not see them
    np.testing.assert_allclose(np32(out)[:, 11:], np32(masked)[:, 11:], atol=ATOL)


def test_fully_masked_row_is_uniform_average_not_nan():
    q, k, v, mask = _inputs(22, 32, 8, seed=2)
    mask[0] = False
    out = np32(local_attention_plain(*_torch(q, k, v), 11, torch.from_numpy(mask), heads=8))
    ref = np.asarray(jax_local_attention(q, k, v, 11, jnp.asarray(mask), heads=8))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    q, k, v, mask = _inputs(22, 32, 8, seed=3)
    before = ops_local_attention.launches
    out = local_attention(*_torch(q, k, v), 11, torch.from_numpy(mask), heads=8)
    plain = local_attention_plain(*_torch(q, k, v), 11, torch.from_numpy(mask), heads=8)
    assert ops_local_attention.launches == before
    assert torch.equal(out, plain)


def _merged_views(n, d, heads, b=2, seed=4, aliased=True):
    """q, k, v as (B, H, N, D) views of (B, N, H·D) activations, and packed copies."""
    rng = np.random.default_rng(seed)
    base = [torch.from_numpy(rng.standard_normal((b, n, heads * d)).astype(np.float32))
            for _ in range(1 if aliased else 3)] * (3 if aliased else 1)
    views = [t.view(b, n, heads, d).transpose(1, 2) for t in base]
    packed = [t.reshape(b * heads, n, d) for t in views]
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, -7:] = False
    return views, packed, mask


@pytest.mark.parametrize("aliased", [True, False], ids=["aliased", "distinct"])
@pytest.mark.parametrize("n,w,d,heads", CASES[2:])
def test_cpu_wrapper_takes_strided_views_and_merged_out(n, w, d, heads, aliased):
    views, packed, mask = _merged_views(n, d, heads, aliased=aliased)
    assert not views[0].is_contiguous()
    assert (views[0].data_ptr() == views[1].data_ptr()) == aliased
    plain = local_attention_plain(*packed, w, mask, heads=heads)
    # strided (B, H, N, D) in, new contiguous tensor of that shape out
    out = ops_local_attention.local_attention(*views, w, mask, heads=heads)
    assert out.shape == views[0].shape and torch.equal(out.reshape(plain.shape), plain)
    # strided in, merged (B, N, H·D) out through `out=`
    merged = torch.full((2, n, heads * d), float("nan"))
    res = local_attention(*views, w, mask, heads=heads,
                          out=merged.view(2, n, heads, d).transpose(1, 2))
    assert res.data_ptr() == merged.data_ptr()
    assert torch.equal(merged, plain.view(2, heads, n, d).transpose(1, 2).reshape(2, n, heads * d))
    # packed in, packed `out=`
    into = torch.empty_like(plain)
    assert ops_local_attention.local_attention(*packed, w, mask, heads=heads, out=into) is into
    assert torch.equal(into, plain)


def test_wrapper_rejects_masks_and_layouts_it_would_have_to_copy():
    views, packed, mask = _merged_views(22, 32, 8)
    q = packed[0]
    for bad in (mask.to(torch.uint8), mask.float(), torch.ones(2, 44, dtype=torch.bool)[:, ::2]):
        with pytest.raises(ValueError, match="contiguous bool"):
            ops_local_attention.local_attention(q, q, q, 11, bad, heads=8)
    with pytest.raises(ValueError, match=r"mask must be \(2, 22\)"):
        ops_local_attention.local_attention(q, q, q, 11, mask[:1], heads=8)
    with pytest.raises(ValueError, match="unit-stride"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        ops_local_attention.local_attention(t, t, t, 11, mask, heads=8)
    with pytest.raises(ValueError, match="float32"):
        ops_local_attention.local_attention(q.double(), q.double(), q.double(), 11, mask, heads=8)
    with pytest.raises(ValueError, match="heads"):
        ops_local_attention.local_attention(*views, 11, mask, heads=4)
    with pytest.raises(ValueError, match="out must be"):
        ops_local_attention.local_attention(q, q, q, 11, mask, heads=8, out=torch.empty(16, 22, 16))
    with pytest.raises(ValueError, match="impl='kernel'"):
        local_attention(q, q, q, 11, mask, heads=8, impl="plain", out=torch.empty_like(q))


def test_rope_heads_is_rope_of_split_heads_without_the_copy():
    from diffusestylegesture_torch.models import rotary

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 22, 64)).astype(np.float32))
    packed = rotary.rope(rotary.heads_split(x, 8))            # (B·H, T, hd)
    kept = rotary.rope_heads(x, 8)                            # (B, T, H, hd)
    assert kept.shape == (2, 22, 8, 8) and kept.is_contiguous()
    assert torch.equal(rotary.heads_merge(packed, 2, 8), kept.reshape(2, 22, 64))
