"""Optimizers and the learning-rate schedule of the two-phase recipe.

The port of ``torchsr_tpu/train/state.py``: the reference's Adam trio
(beta 0.9 / 0.999, eps 1e-8) -- one for the PSNR pretrain and one for
the generator over the generator's parameters, one over the
discriminator's -- with the learning rate set by the host once per
epoch from ``step_lr_schedule``.  ``torch.optim.Adam`` computes
optax's ``scale_by_adam`` step.
"""

from __future__ import annotations

import torch

BASE_LR = 1e-4


def make_adam(params, lr: float = BASE_LR) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)


class Optimizers:
    """The psnr / gen / disc Adam trio."""

    def __init__(self, generator: torch.nn.Module,
                 discriminator: torch.nn.Module):
        self.psnr = make_adam(generator.parameters())
        self.gen = make_adam(generator.parameters())
        self.disc = make_adam(discriminator.parameters())

    def state_dict(self) -> dict:
        return {"psnr_opt_state": self.psnr.state_dict(),
                "gen_opt_state": self.gen.state_dict(),
                "disc_opt_state": self.disc.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        for key, opt in (("psnr_opt_state", self.psnr),
                         ("gen_opt_state", self.gen),
                         ("disc_opt_state", self.disc)):
            if key in state:
                opt.load_state_dict(state[key])


def step_lr_schedule(
    base_lr: float, epoch: int, total_epochs: int, gamma: float = 0.6
) -> float:
    """StepLR(step_size=epochs // 8, gamma=0.6) stepped once per epoch;
    ``epoch`` is 1-based."""
    step_size = max(total_epochs // 8, 1)
    return base_lr * (gamma ** ((epoch - 1) // step_size))
