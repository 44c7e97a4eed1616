"""Scored rows a second: the rows of every request completed in the window,
over the window's length by the host's clock."""
from bench.harness.readers import window_rate


def read(run):
    return window_rate(run, "rows")
