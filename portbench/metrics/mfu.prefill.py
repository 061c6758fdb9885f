"""Model operations of the served prefills (windowed or causal pairs, the head at the last position) over the window at 989 TFLOP/s bf16."""
from portbench.metrics._read import mfu


def read(ctx):
    return mfu(ctx)
