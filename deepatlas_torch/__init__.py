"""DeepAtlas on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch twin of ``deepatlas_tpu``: the same public conventions and the
same numerics, with every Pallas TPU kernel replaced by a CUDA kernel written
for ``sm_90a`` (``deepatlas_torch/kernels``).

Layout convention (shared with the JAX package so tensors compare without
transposes): volumes are channel-last ``(B, D, H, W, C)``, segmentation masks
are ``(B, D, H, W)`` integer tensors, and logits are ``(B, D, H, W,
n_classes)``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
never fall back to the CPU on their own (``resolve_device``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and is not available, instead of carrying on on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
