"""Network weights drawn from the run's seed on the device.

One generator on the device draws every kernel in one call; each kernel is
its slice, scaled to the Glorot normal scale of its fans and truncated at
two deviations, the VoxelMorph flow head at the published N(0, 1e-5).
Biases and BatchNorm take the recipes' start (zeros, unit scale, zero mean,
unit variance) for training.  For serving, the weights stand for a trained
net: biases, BatchNorm scales and shifts and running statistics are drawn
too, in two more calls (the serving job then centres the head's bias on
the data, ``jobs/serve.py``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

FLOW_STD = 1e-5


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make_weights(spec, seed: int, device, serving: bool = False
                 ) -> Dict[str, torch.Tensor]:
    g = generator(seed, device)
    kernels = [(k, s, kind) for k, s, kind in spec if kind in ("w", "flow")]
    z = torch.randn(sum(math.prod(s) for _, s, _ in kernels), generator=g,
                    device=device).clamp_(-2.0, 2.0)
    out, pos = {}, 0
    for name, shape, kind in kernels:
        n = math.prod(shape)
        if kind == "flow":
            std = FLOW_STD
        else:
            receptive = math.prod(shape[:-2])
            std = math.sqrt(2.0 / (receptive * (shape[-2] + shape[-1])))
        out[name] = z[pos:pos + n].view(shape) * std
        pos += n
    rest = [(k, s, kind) for k, s, kind in spec if kind not in ("w", "flow")]
    total = sum(math.prod(s) for _, s, _ in rest)
    if serving:
        noise = torch.randn(total, generator=g, device=device)
        spread = torch.rand(total, generator=g, device=device)
    pos = 0
    for name, shape, kind in rest:
        n = math.prod(shape)
        base = {"g": 1.0, "v": 1.0}.get(kind, 0.0)
        if serving and kind == "v":
            t = 0.5 + spread[pos:pos + n]
        elif serving:
            t = base + 0.1 * noise[pos:pos + n]
        else:
            t = torch.full((n,), base, device=device)
        out[name] = t.view(shape).float()
        pos += n
    return out
