"""Per-layer metric readers: ``read(ctx, **params)`` returns the metric's
value, or None where the run holds nothing to read (never 0 for a share of
a roofline or a peak)."""
