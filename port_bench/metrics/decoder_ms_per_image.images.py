"""Device ms of the neck and heads (MoGe-2: the decode span less the encoder span; MoGe-1: the head span), per image."""

from port_bench.readers import per_image_ms, span


def read(run):
    head = span(run, "pb.head", "device_s")
    if head is None:
        decode, encoder = span(run, "pb.decode", "device_s"), span(run, "pb.encoder", "device_s")
        head = decode - encoder if decode is not None and encoder is not None else None
    return per_image_ms(run, head)
