"""The precision a reference convolution computes in.

``float32`` is the reference itself (TF32 off).  ``fp8`` is the control:
the step below the bfloat16 that the configurations state, where the
networks carry their activations in float8 as the program carries them in
bfloat16.  Each convolution's input, weight and output are rounded to
float8 e4m3 with a per-tensor scale in the forward pass, and the gradients
that reach them to float8 e5m2 in the backward pass; the arithmetic between
roundings stays float32.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a convolution reads it in this precision."""
        return _Fp8.apply(x) if self.name == "fp8" else x


@contextlib.contextmanager
def exact_float32():
    """Plain float32 arithmetic on the card inside the block: no TF32 in
    matrix products or cuDNN convolutions (the flags are put back)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
