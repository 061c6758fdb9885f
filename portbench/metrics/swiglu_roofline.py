"""swiglu's share of its bound (operations at bf16 or bytes, the larger) over its kernels' device time."""
from portbench.metrics._read import roofline


def read(ctx):
    return roofline(ctx, "swiglu")
