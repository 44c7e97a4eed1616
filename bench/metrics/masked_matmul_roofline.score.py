"""``masked_matmul``'s share of its roofline in the traced window, percent: the
summed bound of its launches (counted from shapes by bench/harness/counts.py
at the card's published peaks) over its summed time in the profiler's trace."""
from bench.harness.readers import roofline


def read(run):
    return roofline(run, "masked_matmul")
