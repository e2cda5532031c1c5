"""Device ms of infer's epilogue and postprocess less the camera solve (the program's spans moge.post less moge.solve, by CUDA events), per image, in the profiled tail."""

from port_bench.program_spans import total
from port_bench.readers import per_image_ms


def read(run):
    post, solve = total(run, "moge.post", "device_s"), total(run, "moge.solve", "device_s")
    return per_image_ms(run, post - solve) if post is not None and solve is not None else None
