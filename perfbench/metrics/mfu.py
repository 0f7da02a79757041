"""Model FLOPs of the requests the window counted (perfbench/counts) over the window's seconds, as a share of the TF32 peak."""
from perfbench.harness import readers

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"


def read(ctx):
    return readers.mfu(ctx)
