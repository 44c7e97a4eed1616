"""The whole step's share of the card's peak, percent: the operations the
measured window's work counts (bench/harness/counts.py: masked products by
the pairs the mask keeps, every pair of each learning cycle), each launch's
over the peak of its own precision (all f32 here), over the window's length."""
from bench.harness.readers import mfu


def read(run):
    return mfu(run)
