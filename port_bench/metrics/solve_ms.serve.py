"""Host ms of the camera solve (recover_focal_shift) per infer call, in the profiled tail."""

from port_bench.readers import solve_ms


def read(run):
    return solve_ms(run)
