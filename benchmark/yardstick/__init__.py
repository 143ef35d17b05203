"""The benchmark's yardstick: peaks, work per kernel call, and the passes
each step kind makes."""
