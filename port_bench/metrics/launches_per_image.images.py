"""Kernel and graph launch calls of the host per image, in the profiled tail."""

from port_bench.readers import launches_per_image


def read(run):
    return launches_per_image(run)
