"""Device ms of the encoder's feed-forward (the program's span moge.encoder.ffn around each block's w12, gate and w3, by CUDA events, gaps inside included), per image, in the profiled tail."""

from port_bench.program_spans import total
from port_bench.readers import per_image_ms


def read(run):
    return per_image_ms(run, total(run, "moge.encoder.ffn", "device_s"))
