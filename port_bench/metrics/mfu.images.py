"""Model operations of the images done outside the profiler over that time, at the peak of the cell dtype (%)."""

from port_bench.readers import mfu


def read(run):
    return mfu(run)
