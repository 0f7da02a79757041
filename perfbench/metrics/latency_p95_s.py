"""95th percentile of due-to-resolved seconds over every request due in the open loop's window; a failed or unresolved request counts as infinite."""
from perfbench.harness import readers

LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return readers.latency_p95(ctx)
