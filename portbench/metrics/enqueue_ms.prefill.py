"""Host ms of the prefill call, which returns before the device finishes (no synchronise)."""
from portbench.metrics._read import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "prefill")
