"""Milliseconds in the program's own spans (``annotate`` in
``deepatlas_torch/utils/profiling.py``, read back by ``spans_between``),
taken over the part of the window that the profiler did not record: the
spans named in ``spans`` that lie wholly inside the window and wholly
outside its traced stretch, summed over the window's units that lie wholly
outside that stretch too (``per`` "unit"), or their mean (``per`` "span").
None where the program keeps no span log, where the log has dropped spans
of the window, or where no span or no unit qualifies."""


def outside(start, end, traced) -> bool:
    return not traced or end <= traced[0] or start >= traced[1]


def read(ctx, spans, per):
    try:
        from deepatlas_torch.utils.profiling import spans_between
    except ImportError:
        return None
    w = ctx.window
    events = spans_between(w.t0, w.last)
    if events is None:
        return None
    ms = [1e3 * (e - s) for n, s, e in events
          if n in spans and outside(s, e, w.trace_t)]
    if not ms:
        return None
    if per == "span":
        return sum(ms) / len(ms)
    units = sum(outside(u.t0, u.t1, w.trace_t) for u in w.units)
    return sum(ms) / units if units else None
