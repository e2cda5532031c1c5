"""Host ms of the dispatcher per batch (the program's span moge.serve.dispatch: stacking, infer's launches, the readback's copies), in the profiled tail."""

from port_bench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "moge.serve.dispatch", "host_s")
