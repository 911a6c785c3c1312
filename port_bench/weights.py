"""Seeded weights, made on the device in a few large calls.

A model's parameters are given as specs, ``(name, shape, std, mean)``
(``reference/<family>.py``).  One ``torch.randn`` over all of them from
a ``torch.Generator`` on the device, then one scale and shift by
per-element std and mean (``repeat_interleave`` of the per-leaf
values), in f32, the parameters' type.  The generator's seed is
derived from the run's ``--seed`` and the model part's name, so the
generator, discriminator and VGG draw independent streams.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed from the run's seed (any size) and ``tag``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(
        tag.encode())])
    hi, lo = ss.generate_state(2, dtype=np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


def make(specs: list, seed: int, tag: str,
         device: torch.device | str) -> dict:
    """name -> f32 tensor on ``device`` (views of one buffer)."""
    device = torch.device(device)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    std = torch.tensor([s for _, _, s, _ in specs], device=device)
    mean = torch.tensor([m for _, _, _, m in specs], device=device)
    flat = flat * std.repeat_interleave(counts, output_size=total) \
        + mean.repeat_interleave(counts, output_size=total)
    out, offset = {}, 0
    for (name, shape, _, _), n in zip(specs, sizes):
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    return out


def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``module``'s parameters, which must be the
    same names and shapes exactly (buffers are left as they are)."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        extra = sorted(set(params) ^ set(weights))
        raise ValueError(f"the port's parameters and the benchmark's specs "
                         f"differ: {extra[:6]} ({len(extra)} names)")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: port {tuple(p.shape)}, specs "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
