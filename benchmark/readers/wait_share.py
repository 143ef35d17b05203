"""Share of the window in which the consumer blocked on the loader
(``DataLoader.wait_seconds`` over the window), in %."""


def read(ctx, counter="loader_wait_s"):
    if counter not in ctx.counters or not ctx.counters.get("elapsed_s"):
        return None
    return 100.0 * ctx.counters[counter] / ctx.counters["elapsed_s"]
