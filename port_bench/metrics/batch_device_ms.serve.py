"""Device ms per batch, from the dispatch's start to its readback's copies, gaps inside it included (the CUDA events of the program's span moge.serve.dispatch, not the profiler's), in the profiled tail."""

from port_bench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "moge.serve.dispatch", "device_s")
