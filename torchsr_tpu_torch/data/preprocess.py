"""On-device LR/HR pair synthesis from uint8 crops.

The port of ``torchsr_tpu/data/preprocess.py``: the host only decodes
and slices uint8 crops; on the device they become the HR image in
[0, 1] (flipped per sample) and its LR input, PIL's antialiased bicubic
downscale with the uint8 quantization between and after the passes,
as the reference's ToPILImage -> Resize -> ToTensor round trip gives.
"""

from __future__ import annotations

import torch

from torchsr_tpu_torch.ops.resize import INV_255, bicubic_resize


def _apply_flips(hr: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Per-sample flips: ``flips[:, 0]`` reverses W (horizontal),
    ``flips[:, 1]`` reverses H (vertical), as torchvision's
    RandomHorizontalFlip / RandomVerticalFlip."""
    hflip = flips[:, 0].bool()[:, None, None, None]
    vflip = flips[:, 1].bool()[:, None, None, None]
    hr = torch.where(hflip, hr.flip(2), hr)
    return torch.where(vflip, hr.flip(1), hr)


def synthesize_pair(
    crops_u8: torch.Tensor, flips: torch.Tensor, upscale_factor: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 HR crops (B, S, S, 3) + flip bits (B, 2) -> (lr, hr) f32
    batches in [0, 1], on the crops' device."""
    hr = _apply_flips(crops_u8.float() * INV_255, flips)
    lr_size = hr.shape[1] // upscale_factor
    lr = bicubic_resize(hr, (lr_size, lr_size), quantize=True)
    return lr, hr


def synthesize_eval_triple(
    crops_u8: torch.Tensor, upscale_factor: int = 4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 HR crops -> (lr, bicubic re-upscale of lr, hr), no
    augmentation (the reference's TestData triple)."""
    hr = crops_u8.float() * INV_255
    size = hr.shape[1]
    lr_size = size // upscale_factor
    lr = bicubic_resize(hr, (lr_size, lr_size), quantize=True)
    bic = bicubic_resize(lr, (size, size), quantize=True)
    return lr, bic, hr
