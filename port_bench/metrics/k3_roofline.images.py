"""K3 (3x3 conv): least time of the traced forwards over its kernels device time (%)."""

from port_bench import roofline
from port_bench.readers import roofline_share, shape

KERNELS = ("conv3x3_wgmma", "conv3x3_f32")


def read(run):
    return roofline_share(run, KERNELS, roofline.k3_least_s(*shape(run)))
