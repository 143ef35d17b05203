"""Share of the traced kernels' device time in kernels that are not the
port's own (``csrc/``): the eager PyTorch passes, Adam, the losses, in %."""


def read(ctx, port):
    if ctx.trace is None:
        return None
    total = ctx.trace.kernel_seconds()
    if total <= 0:
        return None
    other = ctx.trace.kernel_seconds(lambda n: not any(p in n for p in port))
    return 100.0 * other / total
