"""Training samples a second: the samples of every hidden and readout epoch
of the window's iterations, over the window's length by the host's clock
(each iteration's evaluate included; the window ends at a synchronize)."""
from bench.harness.readers import window_rate


def read(run):
    return window_rate(run, "samples")
