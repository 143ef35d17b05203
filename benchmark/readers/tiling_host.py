"""Host milliseconds a served volume spends in ``sliding_window_predict``
outside the tile predictor (partition, the host side of the tile batches'
hand-over, assembly)."""


def read(ctx):
    v = ctx.counters.get("tiling_host_s_per_volume")
    return None if v is None else 1e3 * v
