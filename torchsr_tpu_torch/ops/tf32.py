"""The 3xTF32 arithmetic of the f32 kernels on the tensor cores, in
plain PyTorch: each f32 operand split into a TF32 high and low part
(``tf32_split``, as ``csrc/hopper.cuh`` splits it), each product taken
as the three TF32 products ``TF32_TERMS``.  The f32 pair conv
(``ops/pair_conv.py``) and the f32 RDB forward (``ops/rdb.py``) emulate
their kernels with these."""

from __future__ import annotations

import torch

# The f32 operand's low 13 bits, which TF32 drops, and half a TF32 ulp
_TF32_DROP = 0x1FFF
_TF32_HALF = 0x1000
# The three TF32 products of a 3xTF32 f32 product, (A's part, B's part),
# in the kernels' order (the small terms first): A is the operand the
# kernels split in registers (the activations; g in the pair conv's
# dgrad), B the one staged as two planes (the weights; g in its wgrad).
TF32_TERMS = (("hi", "lo"), ("lo", "hi"), ("hi", "hi"))


def tf32_split(t: torch.Tensor):
    """``(hi, lo)`` of an f32 tensor as the kernels split and read it
    (csrc/hopper.cuh ``tf32_split``): hi = t rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero: ``cvt.rna``), lo = t - hi
    (exact in f32) cut to the 19 bits the tensor core reads."""
    bits = t.float().contiguous().view(torch.int32)
    hi = ((bits + _TF32_HALF) & ~_TF32_DROP).view(torch.float32)
    lo = (t.float() - hi).view(torch.int32) & ~_TF32_DROP
    return hi, lo.view(torch.float32)


def tf32_parts(t: torch.Tensor) -> dict:
    """``{"hi": hi, "lo": lo}`` of ``tf32_split(t)``, as ``TF32_TERMS``
    names them."""
    return dict(zip(("hi", "lo"), tf32_split(t)))
