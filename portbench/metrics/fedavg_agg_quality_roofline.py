"""fedavg_agg_quality's share of its bound (bytes of U and the aggregate at 3.35 TB/s) over its kernels' device time."""
from portbench.metrics._read import roofline


def read(ctx):
    return roofline(ctx, "fedavg_agg_quality")
