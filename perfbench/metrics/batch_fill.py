"""Requests per batch slot: requests over (batches x max_batch), for the
batches that served requests due in the window."""
from perfbench.harness import readers

LAYER = "server: sample/server.py"
UNIT = "%"
SOURCE = "program_counter"


def read(ctx):
    return readers.batch_fill(ctx)
