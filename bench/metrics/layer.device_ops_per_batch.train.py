"""Device operations (kernels, copies, fills) of the traced window, from the
profiler's trace, over its hidden and readout batches."""


def read(run):
    t = run.get("traced")
    if not t or not t["summary"]["device_ops"] or not t["batches"]:
        return None
    return t["summary"]["device_ops"] / t["batches"]
