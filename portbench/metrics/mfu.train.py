"""Model operations of the window's steps (forward and backward) over the window at 989 TFLOP/s bf16."""
from portbench.metrics._read import mfu


def read(ctx):
    return mfu(ctx)
