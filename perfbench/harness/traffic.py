"""The one traffic generator: request specs and arrival gaps from a traffic
file's parameters.

A traffic file's `clips` maps each field of a request spec to a distribution:
`{"uniform_int": [lo, hi]}` (whole numbers, both ends in) or
`{"uniform": [lo, hi]}`. Requests come in blocks of `block`: within a block
every field takes the block's evenly spaced quantiles of its distribution,
each field in its own order drawn from the seed. So every seed sends the same
sizes in every block, in another order, and a run's work does not depend on
its seed beyond the order. An open loop's `arrivals` are
`{"poisson": rate_per_s}`: independent exponential gaps drawn from the seed,
so the count of arrivals in any stretch of time varies as independent users'
does.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _quantiles(dist: dict, n: int) -> np.ndarray:
    (kind, args), = dist.items()
    u = (np.arange(n) + 0.5) / n
    if kind == "uniform_int":
        lo, hi = args
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if kind == "uniform":
        lo, hi = args
        return lo + u * (hi - lo)
    raise ValueError(f"unknown distribution {kind!r}")


def _blocks(fields: Dict[str, dict], block: int, seed: int, stream: int) -> Iterator[dict]:
    k = 0
    while True:
        rng = np.random.default_rng([seed, stream, k])
        cols = {name: rng.permutation(_quantiles(dist, block)) for name, dist in fields.items()}
        for i in range(block):
            yield {name: col[i].item() for name, col in cols.items()}
        k += 1


def specs(traffic: dict, seed: int) -> Iterator[dict]:
    """Request specs without end; each carries its index as `id`."""
    for i, spec in enumerate(_blocks(traffic["clips"], traffic["block"], seed, 0)):
        spec["id"] = i
        yield spec


def gaps(traffic: dict, seed: int) -> Iterator[float]:
    """Seconds between consecutive arrivals of an open loop, without end."""
    (kind, rate), = traffic["arrivals"].items()
    if kind != "poisson":
        raise ValueError(f"unknown arrivals {kind!r}")
    rng = np.random.default_rng([seed, 1])
    while True:
        yield float(rng.exponential(1.0 / float(rate)))
