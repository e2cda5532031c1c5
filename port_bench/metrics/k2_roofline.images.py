"""K2 (flash-attention forward): least time of the traced forwards over its kernels device time (%)."""

from port_bench import roofline
from port_bench.readers import roofline_share, shape

KERNELS = ("flash_fwd_wgmma", "flash_fwd_f32")


def read(run):
    return roofline_share(run, KERNELS, roofline.k2_least_s(*shape(run)))
