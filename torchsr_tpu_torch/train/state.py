"""Optimizers and the learning-rate schedule of the two-phase recipe.

The port of ``torchsr_tpu/train/state.py``: the reference's Adam trio
(beta 0.9 / 0.999, eps 1e-8) -- one for the PSNR pretrain and one for
the generator over the generator's parameters, one over the
discriminator's -- with the learning rate set by the host once per
epoch from ``step_lr_schedule``.  ``torch.optim.Adam`` computes
optax's ``scale_by_adam`` step.

On CUDA the trainer replays its steps as CUDA graphs
(``train/graphs.py``), so every value an optimizer step reads must live
on the device: the optimizers are ``fused`` and ``capturable`` (the step
counts are device tensors) and each group's learning rate is a 0-d
device tensor that ``set_lr`` fills in place.  A Python float would be
baked into the graph when it is captured, and every later epoch would
train at that rate.  On the CPU the optimizers are the plain ones, with
float learning rates.
"""

from __future__ import annotations

import torch

BASE_LR = 1e-4


def make_adam(params, lr: float = BASE_LR, *,
              device: torch.device | str = "cpu") -> torch.optim.Adam:
    """The reference's Adam; on CUDA fused and capturable, its learning
    rate a 0-d f32 tensor on ``device``."""
    kw = {"betas": (0.9, 0.999), "eps": 1e-8}
    device = torch.device(device)
    if device.type == "cuda":
        return torch.optim.Adam(
            params, lr=torch.tensor(lr, dtype=torch.float32, device=device),
            fused=True, capturable=True, **kw)
    return torch.optim.Adam(params, lr=lr, **kw)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate to ``lr``: in place where it is a
    device tensor (a graph reads that tensor at each replay)."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def _load_keeping_form(opt: torch.optim.Optimizer, state: dict) -> None:
    """``opt.load_state_dict(state)``, keeping this optimizer's own
    form: its implementation flags and learning-rate objects (the loaded
    values filled into them), and step counts where it keeps them (on
    the parameters' device when capturable, else on the host).  A
    checkpoint written on the other kind of device then loads as well.
    The moments and step counts are new tensors afterwards, so a CUDA
    graph that read the old ones must be captured again."""
    kept = [{k: g[k] for k in ("lr", "fused", "capturable", "foreach")
             if k in g} for g in opt.param_groups]
    opt.load_state_dict(state)
    for group, own in zip(opt.param_groups, kept):
        loaded_lr = float(group["lr"])
        group.update(own)
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(loaded_lr)
        else:
            group["lr"] = loaded_lr
        for p in group["params"]:
            st = opt.state.get(p)
            if not st or "step" not in st:
                continue
            step = torch.as_tensor(st["step"], dtype=torch.float32)
            st["step"] = (step.to(p.device) if group.get("capturable")
                          else step.cpu())


class Optimizers:
    """The psnr / gen / disc Adam trio, on ``device``'s kind."""

    def __init__(self, generator: torch.nn.Module,
                 discriminator: torch.nn.Module, *,
                 device: torch.device | str = "cpu"):
        self.psnr = make_adam(generator.parameters(), device=device)
        self.gen = make_adam(generator.parameters(), device=device)
        self.disc = make_adam(discriminator.parameters(), device=device)

    def all(self) -> tuple:
        return (self.psnr, self.gen, self.disc)

    def state_dict(self) -> dict:
        return {"psnr_opt_state": self.psnr.state_dict(),
                "gen_opt_state": self.gen.state_dict(),
                "disc_opt_state": self.disc.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        for key, opt in (("psnr_opt_state", self.psnr),
                         ("gen_opt_state", self.gen),
                         ("disc_opt_state", self.disc)):
            if key in state:
                _load_keeping_form(opt, state[key])


def step_lr_schedule(
    base_lr: float, epoch: int, total_epochs: int, gamma: float = 0.6
) -> float:
    """StepLR(step_size=epochs // 8, gamma=0.6) stepped once per epoch;
    ``epoch`` is 1-based."""
    step_size = max(total_epochs // 8, 1)
    return base_lr * (gamma ** ((epoch - 1) // step_size))
