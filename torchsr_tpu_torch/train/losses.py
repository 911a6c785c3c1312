"""Loss functions with the reference's torch semantics, in f32.

The port of ``torchsr_tpu/train/losses.py``.  ESRGAN wires: pretrain
L1(sr, hr); discriminator the relativistic-average
[BCEwL(D(hr) - mean D(sr), 1) + BCEwL(D(sr) - mean D(hr), 0)] / 2;
generator 0.01 L1 + VGG-L1 + 0.005 BCEwL(D(sr) - mean D(hr), 1).
All reductions are means.
"""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on probabilities, clipped to [1e-7, 1 - 1e-7]
    before the log so that a saturated discriminator keeps finite
    gradients (the JAX package's form: the loss caps near 16)."""
    probs = probs.float().clamp(1e-7, 1.0 - 1e-7)
    targets = targets.float()
    return -(targets * torch.log(probs)
             + (1.0 - targets) * torch.log1p(-probs)).mean()


def bce_with_logits_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """Numerically stable BCE on logits: max(x, 0) - x t + log(1 +
    exp(-|x|)), averaged."""
    x, t = logits.float(), targets.float()
    return (x.clamp_min(0.0) - x * t
            + torch.log1p(torch.exp(-x.abs()))).mean()
