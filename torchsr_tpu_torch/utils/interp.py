"""Network interpolation: blend PSNR-oriented and GAN-oriented generators.

The port of ``torchsr_tpu/utils/interp.py`` (the ESRGAN paper's
section 3.4): every parameter of the PSNR-pretrained and the
GAN-finetuned generator is blended,

    theta_interp = (1 - alpha) * theta_PSNR + alpha * theta_GAN,

for a perception/distortion tradeoff without retraining.  SRGAN's
BatchNorm running statistics are blended with the same alpha.  A torch
``state_dict`` also holds each BatchNorm's integer
``num_batches_tracked``, a leaf the JAX tree has no counterpart of; it
is blended the same way and rounded to the nearest integer, so alpha 0
and alpha 1 return each input's count exactly (the count only matters
to a BatchNorm whose momentum is None, which the port never uses).
"""

from __future__ import annotations

import torch

from torchsr_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def interpolate_states(psnr_state: dict, gan_state: dict,
                       alpha: float) -> dict:
    """Keywise ``(1 - alpha) * psnr + alpha * gan`` over two generator
    ``state_dict``s, each floating tensor blended in f32 and cast back
    to its dtype, integer tensors blended in f64 and rounded.

    Both must hold the same keys with the same shapes (the same
    architecture); a mismatch raises ``ValueError``."""
    if set(psnr_state) != set(gan_state):
        missing = sorted(set(psnr_state) ^ set(gan_state))
        raise ValueError(
            "checkpoint parameter trees differ: both checkpoints must "
            "come from the same model architecture (keys in one only: "
            f"{missing[:8]}{' ...' if len(missing) > 8 else ''})"
        )
    a = float(alpha)
    out = {}
    for key, p in psnr_state.items():
        g = gan_state[key]
        if p.shape != g.shape:
            raise ValueError(
                f"parameter shape mismatch between checkpoints at {key}: "
                f"{tuple(p.shape)} vs {tuple(g.shape)}"
            )
        if p.is_floating_point():
            blend = (1.0 - a) * p.float() + a * g.float()
        else:
            blend = ((1.0 - a) * p.double() + a * g.double()).round()
        out[key] = blend.to(p.dtype)
    return out


def interpolate_checkpoints(
    psnr_path: str,
    gan_path: str,
    alpha: float,
    output: str,
    model: str | None = None,
) -> str:
    """Load two checkpoints (``.pth`` or the JAX package's ``.ckpt``),
    blend the generator states, and write the port's checkpoint
    (``torch.save``), which ``test``, ``serve`` and ``eval`` load.

    Returns the output path.  The result's phase is ``"interp"`` and its
    epoch the larger of the two inputs' (metadata only)."""
    ckpts = []
    for path in (psnr_path, gan_path):
        ckpt = load_checkpoint(path, model)
        if ckpt is None:
            raise FileNotFoundError(f"checkpoint not found: {path}")
        ckpts.append(ckpt)
    blended = interpolate_states(ckpts[0]["state"], ckpts[1]["state"],
                                 alpha)
    epoch = max(int(c.get("epoch", 1)) for c in ckpts)
    save_checkpoint(output, epoch, "interp", blended)
    return output
