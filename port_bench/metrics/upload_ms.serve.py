"""Host ms per call of infer's upload (the program's span moge.upload: the images to the card as fp32), in the profiled tail."""

from port_bench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "moge.upload", "host_s")
