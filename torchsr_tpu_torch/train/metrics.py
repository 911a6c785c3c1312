"""Image quality metrics: the reference's PSNR and Gaussian SSIM.

The port of ``torchsr_tpu/train/metrics.py``.  PSNR is ``10 log10(1 /
batch MSE)`` on [0, 1] pixels (one log per batch).  SSIM is the
standard Gaussian-windowed form (11 x 11, sigma 1.5, K1 0.01, K2 0.03,
data range 1), averaged over channels, with the separable blur as two
products with banded matrices over the spatial axes, in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Batch PSNR in dB over all pixels."""
    mse = (pred.float() - target.float()).square().mean()
    return 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))


def mse_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE (B,)."""
    d = (pred.float() - target.float()).square()
    return d.mean(dim=tuple(range(1, d.dim())))


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _blur_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """Banded (n - w + 1, n) matrix of a VALID 1-D Gaussian filter."""
    g = _gaussian_window(window_size, sigma)
    out = n - window_size + 1
    mat = np.zeros((out, n), dtype=np.float32)
    for i in range(out):
        mat[i, i:i + window_size] = g
    return mat


def ssim_per_sample(
    pred: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    data_range: float = 1.0,
) -> torch.Tensor:
    """Per-sample mean SSIM (B,) of NHWC batches."""
    pred, target = pred.float(), target.float()
    h, w = pred.shape[1], pred.shape[2]
    gh = torch.from_numpy(_blur_matrix(h, window_size, sigma)).to(pred.device)
    gw = torch.from_numpy(_blur_matrix(w, window_size, sigma)).to(pred.device)

    def blur(x: torch.Tensor) -> torch.Tensor:
        x = torch.einsum("oh,bhwc->bowc", gh, x)
        return torch.einsum("ow,bhwc->bhoc", gw, x)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p, mu_t = blur(pred), blur(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    var_p = blur(pred * pred) - mu_pp
    var_t = blur(target * target) - mu_tt
    cov = blur(pred * target) - mu_pt
    ssim_map = ((2.0 * mu_pt + c1) * (2.0 * cov + c2)) / (
        (mu_pp + mu_tt + c1) * (var_p + var_t + c2)
    )
    return ssim_map.mean(dim=(1, 2, 3))
