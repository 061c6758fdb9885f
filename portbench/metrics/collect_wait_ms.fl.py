"""Host ms blocked in the trainer's collect (DeviceFLSim.collect), a round."""
from portbench.metrics._read import span_per_unit_ms


def read(ctx):
    return span_per_unit_ms(ctx, "collect")
