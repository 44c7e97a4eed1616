"""The whole step's share of the card's f32 peak, percent: the operations
the measured window's work counts (bench/harness/counts.py: masked products
by the pairs the mask keeps, every pair of each learning cycle) over the
window's length times the peak."""
from bench.harness.readers import mfu


def read(run):
    return mfu(run)
