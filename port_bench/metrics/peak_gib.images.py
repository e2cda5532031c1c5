"""Device memory allocated at most during the window, after a reset at its start (GiB)."""

from port_bench.readers import peak_gib


def read(run):
    return peak_gib(run)
