"""Host ms of one stage-2 schedule (FLServiceProvider.schedule_period), the mean over the periods scheduled in the window."""
from portbench.metrics._read import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "schedule_period")
