"""Motion frames delivered over the window's time: from the first completion at or after warm-up to the first at or after --seconds, whole requests, every stall inside counted."""
from perfbench.harness import readers

LAYER = "end to end"
UNIT = "frames/s"
SOURCE = "host_clock"


def read(ctx):
    return readers.frames_per_s(ctx)
