"""Cross-entropy family: CE, soft CE, focal, on channel-last logits.

Counterpart of ``deepatlas_tpu/losses/entropy.py`` (plain torch ops: the
JAX package has no kernel for them either):
  * ``cross_entropy_loss`` -- mean over all voxels of -log softmax at the
    target class (torch ``nn.CrossEntropyLoss`` semantics).
  * ``soft_cross_entropy_loss`` -- probabilistic targets.
  * ``focal_loss`` -- the *intended* focal loss -alpha_t (1 - p_t)^gamma
    log(p_t).  The JAX module documents its divergence from the original
    reference, whose ``F.nll_loss(P, targets)`` is ``-p_t`` and so gives a
    modulating factor ``(1 + p_t)^gamma``; this port keeps the JAX
    package's standard form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import one_hot


def _target_log_prob(logits: torch.Tensor, target: torch.Tensor):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, target.long().unsqueeze(-1))[..., 0]


def cross_entropy_loss(logits: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Mean CE over all voxels; logits (B, D, H, W, C), target int
    (B, D, H, W)."""
    return -_target_log_prob(logits, target).mean()


def soft_cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor,
                            n_class: Optional[int] = None,
                            softmax: bool = False) -> torch.Tensor:
    """CE with probabilistic targets: mean over voxels of sum_c -t_c log p_c.

    Args:
      pred: ``(B, D, H, W, C)`` logits (softmax=True) or probabilities.
      target: ``(B, D, H, W)`` integer labels or ``(B, D, H, W, C)`` probs.
    """
    if target.dim() == pred.dim() - 1:
        target = one_hot(target, n_class or pred.shape[-1], dtype=pred.dtype)
    if softmax:
        logp = torch.log_softmax(pred, dim=-1)
    else:
        logp = torch.log(pred.clamp(min=1e-8))
    return torch.sum(-target * logp, dim=-1).mean()


def focal_loss(logits: torch.Tensor, target: torch.Tensor, class_num: int,
               alpha: Optional[Sequence[float]] = None, gamma: float = 2.0,
               size_average: bool = True) -> torch.Tensor:
    """Standard focal loss: -alpha_t (1 - p_t)^gamma log(p_t); the mean over
    voxels with ``size_average``, else the sum.  ``class_num`` is taken
    for the reference's signature; the classes are the logits' last axis."""
    t = target.long()
    logp_t = _target_log_prob(logits, t)
    p_t = logp_t.exp()
    if alpha is None:
        alpha_t = torch.ones_like(p_t)
    else:
        alpha_t = torch.as_tensor(alpha, dtype=logits.dtype,
                                  device=logits.device).reshape(-1)[t]
    loss = -alpha_t * (1.0 - p_t) ** gamma * logp_t
    return loss.mean() if size_average else loss.sum()
