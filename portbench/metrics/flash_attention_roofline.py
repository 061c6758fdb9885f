"""flash_attention's share of its bound (operations over the causal or windowed pairs at bf16, or bytes) over its kernels' device time."""
from portbench.metrics._read import roofline


def read(ctx):
    return roofline(ctx, "flash_attention")
