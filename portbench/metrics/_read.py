"""Shared arithmetic of the per-layer readers (each metric keeps a file
of its own that names what it reads)."""
from __future__ import annotations

from portbench.yardstick.peaks import PEAK_BF16_FLOPS, bound_s

# the profiler's names of each op's kernels
KERNELS = {"fedavg_agg_quality": r"^(agg_quality_partials|reduce_partials)",
           "swiglu": r"^swiglu_",
           "flash_attention": r"^fa_(wgmma|mma|simple)_kernel"}


def idle_pct(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx):
    if ctx.trace is None or not ctx.flops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.trace.window_s * PEAK_BF16_FLOPS)


def roofline(ctx, op: str):
    """The op's least time (the larger of its operations over the peak
    and its bytes over the memory rate) times its calls in the window,
    over its kernels' device time."""
    calls = ctx.launches.get(op, 0)
    if ctx.trace is None or not calls or op not in ctx.costs:
        return None
    dev_s, _ = ctx.trace.kernel_seconds(KERNELS[op])
    if dev_s <= 0:
        return None
    ops_, nbytes, peak = ctx.costs[op]
    t, _ = bound_s(ops_, nbytes, peak or PEAK_BF16_FLOPS)
    return 100.0 * t * calls / dev_s


def launches_per_unit(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return ctx.trace.launches() / ctx.units


def span_mean_ms(ctx, name: str):
    d = ctx.spans.durations_s(name)
    return 1e3 * sum(d) / len(d) if d else None


def span_per_unit_ms(ctx, name: str):
    d = ctx.spans.durations_s(name)
    if not d or not ctx.units:
        return None
    return 1e3 * sum(d) / ctx.units
