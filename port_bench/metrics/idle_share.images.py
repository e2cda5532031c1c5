"""Share of the profiled tail in which no kernel or copy ran on the device (%)."""

from port_bench.readers import idle_share


def read(run):
    return idle_share(run)
