"""Windowed causal local attention of the PyTorch port vs the JAX package.

The port's plain version is held against the JAX XLA path and the Pallas
kernel (interpret mode) at atol 1e-5 (float32, same operation order up to
the einsum's summation over D ≤ 48 terms). The CUDA kernel is held against
the plain version on a card in `test_torch_isolation.py`.
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

CASES = [(22, 11, 32, 8), (30, 15, 48, 8), (88, 11, 32, 8)]
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
