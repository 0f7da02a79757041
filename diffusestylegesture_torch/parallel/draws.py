"""Random draws that do not depend on how the batch is sharded.

A rank that holds rows [start, stop) of a global batch draws what the
unsharded run draws for those rows: each batch-major draw is made at the
global batch size from the same generator state on every rank, and the rank
keeps its rows. The JAX package gets this from its global arrays (one key
over the whole batch under GSPMD); here every data-parallel rank spends the
draws of the whole batch, which are small beside the step.

Every draw site of the train step and of the models goes through these
functions with a `torch.Generator` (or None, the device's default), or a
`GlobalDraws` when the batch is sharded; with a plain generator they are
exactly `torch.rand` / `randn` / `randint` / `multinomial`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class GlobalDraws:
    """`generator`'s draws made at a global batch of `total` rows, of which
    this rank keeps rows [start, stop)."""

    generator: torch.Generator
    start: int
    stop: int
    total: int

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.start:self.stop]

    def global_shape(self, shape: Sequence[int]) -> tuple:
        shape = tuple(shape)
        if shape[0] != self.stop - self.start:
            raise ValueError(f"a batch-major draw of {shape[0]} rows on a rank that holds "
                             f"{self.stop - self.start}")
        return (self.total,) + shape[1:]


Draws = Union[None, torch.Generator, GlobalDraws]


def local(generator: Draws) -> Optional[torch.Generator]:
    """The generator itself, for a draw that is not batch-major (every rank
    makes the same one)."""
    return generator.generator if isinstance(generator, GlobalDraws) else generator


def rand(shape: Sequence[int], generator: Draws, device, dtype=torch.float32) -> torch.Tensor:
    if isinstance(generator, GlobalDraws):
        return generator.rows(torch.rand(generator.global_shape(shape),
                                         generator=generator.generator, device=device,
                                         dtype=dtype))
    return torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)


def randn(shape: Sequence[int], generator: Draws, device) -> torch.Tensor:
    if isinstance(generator, GlobalDraws):
        return generator.rows(torch.randn(generator.global_shape(shape),
                                          generator=generator.generator, device=device))
    return torch.randn(tuple(shape), generator=generator, device=device)


def randint(high: int, shape: Sequence[int], generator: Draws, device) -> torch.Tensor:
    if isinstance(generator, GlobalDraws):
        return generator.rows(torch.randint(0, high, generator.global_shape(shape),
                                            generator=generator.generator, device=device))
    return torch.randint(0, high, tuple(shape), generator=generator, device=device)


def multinomial(p: torch.Tensor, n: int, generator: Draws) -> torch.Tensor:
    """n indices drawn with replacement from the distribution p."""
    if isinstance(generator, GlobalDraws):
        return generator.rows(torch.multinomial(p, generator.global_shape((n,))[0],
                                                replacement=True,
                                                generator=generator.generator))
    return torch.multinomial(p, n, replacement=True, generator=generator)
