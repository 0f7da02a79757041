"""Share of the traced slice in which no operation ran on the card."""
from perfbench.harness import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    return readers.device_idle_share(ctx)
