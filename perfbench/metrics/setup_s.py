"""Process start to the first measured request: kernel libraries, weights made on the card, the cell's graphs captured and warmed."""
LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
