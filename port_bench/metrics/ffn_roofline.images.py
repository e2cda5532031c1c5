"""The encoder's feed-forward: least time of the calls of the program's span moge.encoder.ffn over their summed device time (CUDA events), in the profiled tail (%)."""

from port_bench import roofline
from port_bench.program_spans import summary, total
from port_bench.readers import shape
from port_bench.reference.vit import ARCHS, ffn_hidden

SPAN = "moge.encoder.ffn"


def ffn_fwd(arch: str, batch: int, tokens: int, dtype: str):
    """(flops, bytes) of one feed-forward call over ``tokens`` patches and
    the cls token: the MLP's fc1 and fc2 (2 D hidden multiply-adds a token)
    or the fused SwiGLU's w12 and w3 (3 D hidden); the weights and biases
    read, the input read and the output written, once each."""
    dim, _, _, ffn = ARCHS[arch]
    hidden = ffn_hidden(arch)
    first = 2 * hidden if ffn == "swiglu" else hidden  # the first linear's outputs
    macs = dim * first + hidden * dim
    rows = batch * (tokens + 1)
    return 2.0 * rows * macs, (macs + first + dim + 2 * rows * dim) * roofline.ELEM_BYTES[dtype]


def least_s_per_call(run) -> float:
    """One call's least time at the cell's shape: its batch, and the patches of its token grid."""
    version, cfg, batch, h, w, n, dtype = shape(run)
    gh, gw, _, _ = roofline.grid(version, cfg, h, w, n)
    arch = cfg["encoder"]["backbone"] if version == "v2" else cfg["encoder"]
    return roofline.least_s(*ffn_fwd(arch, batch, gh * gw, dtype), dtype)


def read(run):
    seconds = total(run, SPAN, "device_s")
    if seconds is None:
        return None
    return 100.0 * summary(run)[SPAN]["count"] * least_s_per_call(run) / seconds
