"""Model operations of the window's rounds (forward, backward to the activations, the adapters' products) over the window at 989 TFLOP/s bf16."""
from portbench.metrics._read import mfu


def read(ctx):
    return mfu(ctx)
