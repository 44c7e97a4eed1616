"""The 95th percentile of every request's latency in the window, from its
issue to its class ids on the host, in ms (host clock)."""
import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run["window"]["records"]]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
