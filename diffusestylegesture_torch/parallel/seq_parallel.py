"""Sequence-parallel windowed local attention (context parallelism).

Port of `diffusestylegesture_tpu/parallel/seq_parallel.py`. Each w-query
window attends only to itself and the previous window, so the time axis
shards over a `seq` process group with one exchange per call: rank i sends
its last window of keys, values and mask to rank i + 1 (`comm.shift_right`,
send / recv; its backward sends the halo's gradient back), and each rank
attends over [halo | its shard]. Rank 0's halo is the ring's wrap-around and
is masked out, as window 0's previous keys are in the unsharded attention.

`T % (shards · w) == 0`: every shard holds whole windows (ZEGGS T 88, w 11:
2, 4 or 8 shards; TWH T 150, w 15: 2 or 5, not 4).

The model calls `sequence_parallel_local_attention` on replicated q / k / v
(every rank of the group holds the whole sequence, as the rest of the
denoiser runs replicated): each rank keeps its time shard (its backward
all-gathers the shards' gradients), attends, and the shards' outputs are
all-gathered back. Inside, `local_attention_sharded` is the per-shard step:

* the plain version, `local_attn_shard`, mirrors the JAX `_local_attn_shard`
  (float32 scores, -maxfloat masking, the halo's positions one window
  before the shard);
* under `no_grad` on a card, kernel A runs once per shard over the
  concatenation [halo | shard] with the mask [halo mask | shard mask], and
  the halo window's own output is dropped: the kernel takes contiguous
  packed q / k / v and a contiguous bool mask, so this costs one copy of q,
  k, v and the mask per call.

Rows whose every key is masked are undefined, as in JAX (its module
docstring): with a mask that leaves every row a key the three paths agree.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import comm

NEG_INF = -torch.finfo(torch.float32).max


def check_shards(n: int, window_size: int, shards: int) -> None:
    if n % (shards * window_size):
        raise ValueError(
            f"sequence parallelism needs T % (shards · window) == 0: T={n} does not divide into "
            f"{shards} shards of whole {window_size}-frame windows")


def local_attn_shard(q, k, v, mask, k_halo, v_halo, m_halo, pos0: int, window: int):
    """Per-shard windowed attention with an explicit left halo window (the
    JAX `_local_attn_shard`). q / k / v: (BH, Ts, D) this shard; *_halo:
    (BH, w, D) and (BH, w) from the left neighbour (masked on shard 0);
    mask: (BH, Ts) float, > 0.5 = attend; pos0: the shard's first global
    position."""
    bh, ts, d = q.shape
    w = window
    W = ts // w
    scale = d ** -0.5
    bq = q.reshape(bh, W, w, d)
    kw = k.reshape(bh, W, w, d)
    vw = v.reshape(bh, W, w, d)
    prev_k = torch.cat([k_halo[:, None], kw[:, :-1]], dim=1)
    prev_v = torch.cat([v_halo[:, None], vw[:, :-1]], dim=1)
    bk = torch.cat([prev_k, kw], dim=2)
    bv = torch.cat([prev_v, vw], dim=2)
    pos = pos0 + torch.arange(ts, device=q.device).reshape(1, W, w)
    bq_t = pos[..., :, None]
    kpos_prev = torch.cat([pos[:, :1] - w, pos[:, :-1]], dim=1)
    bq_k = torch.cat([kpos_prev, pos], dim=2)[..., None, :]
    with torch.autocast(q.device.type, enabled=False):
        sim = torch.einsum("bwie,bwje->bwij", bq.float(), bk.float()) * scale
        sim = sim.masked_fill(bq_t < bq_k, NEG_INF)
        mw = mask.reshape(bh, W, w)
        m_prev = torch.cat([m_halo[:, None], mw[:, :-1]], dim=1)
        key_mask = torch.cat([m_prev, mw], dim=2)[:, :, None, :] > 0.5
        sim = sim.masked_fill(~key_mask, NEG_INF)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bwij,bwje->bwie", attn, bv.float())
    return out.reshape(bh, ts, d).to(q.dtype)


def local_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
                            mask: torch.Tensor, group, *, heads: int = 1,
                            impl: str = "kernel") -> torch.Tensor:
    """One rank's step: q / k / v (B·H, Ts, D) and mask (B, Ts) bool are this
    rank's shard of the time axis; returns its output shard. impl="kernel"
    takes kernel A on a card under no_grad (module docstring), the plain
    version otherwise."""
    bh, ts, d = q.shape
    w = window_size
    n, r = comm.size(group), comm.rank(group)
    check_shards(ts * n, w, n)
    b = mask.shape[0]
    k_halo = comm.shift_right(k[:, -w:], group)
    v_halo = comm.shift_right(v[:, -w:], group)
    m_halo = comm.shift_right(mask[:, -w:].contiguous(), group)
    if r == 0:
        m_halo = torch.zeros_like(m_halo)
    on_card = q.device.type == "cuda" and impl == "kernel" and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
    if on_card:
        from ..ops.local_attention import local_attention as kernel_a

        ext = [torch.cat([h, t], dim=1) for h, t in ((k_halo, q), (k_halo, k), (v_halo, v))]
        m_ext = torch.cat([m_halo.bool(), mask.bool()], dim=1).contiguous()
        return kernel_a(*ext, w, m_ext, heads=heads)[:, w:]
    mf = mask.float()[:, None, :].expand(b, heads, ts).reshape(bh, ts)
    mh = m_halo.float()[:, None, :].expand(b, heads, w).reshape(bh, w)
    return local_attn_shard(q, k, v, mf, k_halo, v_halo, mh, r * ts, w)


def sequence_parallel_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      window_size: int, group, mask: Optional[torch.Tensor] = None,
                                      heads: int = 1, impl: str = "kernel") -> torch.Tensor:
    """The semantics of `models.local_attention.local_attention` with a user
    mask, q / k / v (B·H, N, D) replicated over the `seq` group `group`:
    each rank attends over its N / shards frames and the result is
    all-gathered, (B·H, N, D) on every rank."""
    bh, n, d = q.shape
    shards = comm.size(group)
    check_shards(n, window_size, shards)
    if mask is None:
        mask = torch.ones(bh // heads, n, dtype=torch.bool, device=q.device)
    q_s, k_s, v_s = (comm.split_to(t, group, 1) for t in (q, k, v))
    m_s = mask.chunk(shards, dim=1)[comm.rank(group)].contiguous()
    out = local_attention_sharded(q_s, k_s, v_s, window_size, m_s, group, heads=heads, impl=impl)
    return comm.gather_from(out, group, 1)
