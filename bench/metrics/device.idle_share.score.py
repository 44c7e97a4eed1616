"""Percent of the traced window in which no device operation ran (the union
of the trace's kernels, copies and fills, overlaps counted once)."""
from bench.harness.readers import idle_share


def read(run):
    return idle_share(run)
