"""Share of the windows WavLM encodes that carry no request's audio (rows
padded to max_batch, windows past a clip's end up to its bucket): 100 ×
`windows_padding` ÷ `windows_encoded`, the server's own counters over every
batch it dispatched in the run (the window and its drain)."""
from perfbench.harness import program

LAYER = "server: sample/server.py"
UNIT = "%"
SOURCE = "program_counter"


def read(ctx):
    return program.counted_padded_share(getattr(ctx.system, "server", None))
