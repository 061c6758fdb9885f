"""CUDA kernel launches a FedSGD step, from the device trace."""
from portbench.metrics._read import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
