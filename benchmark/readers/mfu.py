"""Model FLOPs of the window's units over the window's seconds and the
card's bfloat16 peak, in %: each unit's FLOPs counted from the
configuration's layer shapes (``yardstick.passes``), not from launches."""
from yardstick.passes import model_flops
from yardstick.peaks import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    if not w.units or w.elapsed <= 0:
        return None
    flops = sum(model_flops(ctx.config, u.kind, u.samples) for u in w.units)
    return 100.0 * flops / w.elapsed / PEAK_FLOPS["bfloat16"]
