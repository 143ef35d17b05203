"""A quantile of the per-unit latencies of the window, in seconds
(``statistics.quantiles`` with ``n`` cut points, the ``k``-th of them)."""
import statistics


def read(ctx, counter="volume_latency_s", n=10, k=9):
    values = ctx.counters.get(counter) or []
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=n)[k - 1]
