"""A kernel's share of its roofline over the traced stretch, in %: the
least time of the work the traced units hand to ``kernels``
(``yardstick.passes``) over the device time of the trace's kernels whose
names hold one of ``match``."""
from yardstick.passes import kernel_bound_s


def read(ctx, kernels, match):
    if ctx.trace is None:
        return None
    spent = ctx.trace.kernel_seconds(lambda n: any(m in n for m in match))
    bound = sum(kernel_bound_s(ctx.config, u.kind, kernels, u.samples)
                for u in ctx.window.traced_units())
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
