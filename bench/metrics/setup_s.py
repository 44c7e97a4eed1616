"""Set-up seconds: from the start of the process to the end of set-up
(imports, the kernels' build or load, the data, the network, its compile
and the warm-up work), by the host's clock."""


def read(run):
    return run["setup_s"]
