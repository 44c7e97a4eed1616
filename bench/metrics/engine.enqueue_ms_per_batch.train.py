"""Host milliseconds the phase program and epoch engine spend enqueueing a
training batch: the measured window's ``FitResult.history`` ``host_s`` (each
epoch's and projection's host span before its one synchronize), summed,
over the window's hidden and readout batches."""


def read(run):
    w = run["window"]
    host = sum(e["host_s"] for r in w["records"] for e in r["history"])
    return 1e3 * host / w["batches"] if w["batches"] else None
