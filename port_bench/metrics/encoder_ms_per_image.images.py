"""Device ms of the kernels inside the encoder span, per image, in the profiled tail."""

from port_bench.readers import per_image_ms, span


def read(run):
    return per_image_ms(run, span(run, "pb.encoder", "device_s"))
