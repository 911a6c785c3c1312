"""HAT's residual adds and LayerNorm in one pass over (..., C) token
rows: one CUDA kernel, and its plain version.

``add_layer_norm(x, terms, scales, weight=..., bias=...)`` returns
``(stream, normed)``: the residual stream ``x`` with the pending terms
added (``stream = x + terms[0] * scales[0] + terms[1] * scales[1]``,
rounded to x's dtype after each product and each add, as ``models/hat.py``
composed them), and that stream under ``nn.LayerNorm`` over its last axis
(statistics in f32, the result in x's dtype).  With no terms the stream is
``x`` itself.  HAT calls it for every LayerNorm of its trunk, so that the
residual adds before a LayerNorm are no passes of their own.

The plain version (``add_layer_norm_reference``) is that composition as
the model ran it before: the adds in order, then ``F.layer_norm`` on an f32
copy of the stream, cast back.  The wrapper takes it for CPU tensors only.
For CUDA tensors it launches the kernel (``csrc/add_ln.cu``) or raises:
bf16 only (an f32 form of the kernel does not exist yet, so f32 CUDA input
raises and names it), at most two terms, C a multiple of 4 in [4, 512],
x and the terms contiguous, of one shape and 16-byte aligned, weight and
bias f32 of shape (C,).

The kernel replaces no TPU kernel (the JAX package has no HAT).  It was
added because at HAT's serving tile batch, (8, 256, 256, 180) in bf16 (189
MB a map), each LayerNorm made an f32 copy of the map, ran PyTorch's
LayerNorm on it and cast the result back, and the residual adds before it
made passes of their own.  Its bound is bytes: two terms read three maps
and write two (0.282 ms at 3.35 TB/s), one term reads two and writes two
(0.225 ms).  The design: one CTA a run of rows, copied into shared memory
with 16-byte copies, each row reduced there by a warp (design in the
source).  It launches on the current stream and allocates nothing, so its
launches are captured in ``TileForward``'s graph.

Counters (plain integers, ``ops.MODEL_KERNELS``; ``train/graphs.py`` and
``infer/tiled.py`` add a captured graph's share once per replay):
``ADD_LN_LAUNCHES`` counts kernel launches, ``ADD_LN_TERMS`` the residual
terms added into the stream, by either version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ADD_LN_LAUNCHES = 0
ADD_LN_TERMS = 0
COUNTER_HELP = {
    "ADD_LN_LAUNCHES": "add + LayerNorm kernel launches (HAT)",
    "ADD_LN_TERMS": "residual terms added into the stream by add + "
                    "LayerNorm",
}
LAUNCH_COUNTERS = tuple(COUNTER_HELP)

# What the kernel takes (csrc/add_ln.cu).
MAX_TERMS = 2
MAX_C = 512


def add_layer_norm_reference(x: torch.Tensor, terms, scales, weight,
                             bias, eps: float = 1e-5):
    """The plain version (module docstring): ``(stream, normed)``."""
    stream = x
    for t, s in zip(terms, scales):
        stream = stream + (t if s == 1 else t * s)
    normed = F.layer_norm(stream.float(), weight.shape, weight, bias,
                          eps).to(stream.dtype)
    return stream, normed


def _check(x: torch.Tensor, terms, scales, weight, bias) -> None:
    if len(terms) > MAX_TERMS:
        raise ValueError(f"add_layer_norm takes at most {MAX_TERMS} terms, "
                         f"got {len(terms)}")
    if len(scales) != len(terms):
        raise ValueError(f"add_layer_norm: {len(terms)} terms but "
                         f"{len(scales)} scales")
    for t in terms:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"add_layer_norm's terms must match x ({tuple(x.shape)}, "
                f"{x.dtype}, {x.device}); got {tuple(t.shape)}, {t.dtype}, "
                f"{t.device}")
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"add_layer_norm's weight and bias must be ({c},), "
                         f"got {tuple(weight.shape)} and {tuple(bias.shape)}")


def _kernel_checks(x: torch.Tensor, terms, weight, bias) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype == torch.float32:
        raise NotImplementedError(
            "add_layer_norm: the CUDA kernel is bf16 only; an f32 form of it "
            "does not exist yet (serve HAT without --disable-amp, or run the "
            "plain version on the CPU)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"add_layer_norm takes bfloat16 on CUDA, not "
                        f"{x.dtype}")
    c = x.shape[-1]
    if c % 4 or not 4 <= c <= MAX_C:
        raise ValueError(f"add_layer_norm: the kernel takes C a multiple of "
                         f"4 in [4, {MAX_C}], got C = {c}")
    if x.numel() // c >= 2 ** 31:
        raise ValueError("add_layer_norm: the kernel takes fewer than 2^31 "
                         "rows")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (x, *terms)):
        raise ValueError("add_layer_norm takes x and its terms contiguous "
                         "and 16-byte aligned")
    if any(p.device != x.device or p.dtype != torch.float32
           or not p.is_contiguous() or p.data_ptr() % 16
           for p in (weight, bias)):
        raise ValueError(f"add_layer_norm takes a contiguous, 16-byte "
                         f"aligned f32 weight and bias on {x.device}")


def _launch(x, terms, scales, weight, bias, eps):
    from torchsr_tpu_torch.ops._build import load_library
    from torchsr_tpu_torch.ops.rdb import _raise_on

    c = x.shape[-1]
    stream = torch.empty_like(x) if terms else x
    normed = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in terms] + [0] * (MAX_TERMS - len(terms))
    sc = [float(s) for s in scales] + [1.0] * (MAX_TERMS - len(scales))
    lib = load_library("add_ln")
    dev = x.device
    err = lib.add_ln_launch(
        x.data_ptr(), ptrs[0], ptrs[1], stream.data_ptr(), normed.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), len(terms), sc[0], sc[1],
        float(eps), x.numel() // c, c, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.add_ln_error_string, "add_layer_norm")
    return stream, normed


def add_layer_norm(x: torch.Tensor, terms=(), scales=None, *,
                   weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5):
    """``x`` plus ``terms`` (each times its scale, 1 by default), and that
    stream normalised over its last axis: ``(stream, normed)`` (module
    docstring); the plain version on the CPU, the kernel on CUDA."""
    global ADD_LN_LAUNCHES, ADD_LN_TERMS
    terms = tuple(terms)
    scales = (1.0,) * len(terms) if scales is None else tuple(scales)
    _check(x, terms, scales, weight, bias)
    if x.device.type == "cpu":
        out = add_layer_norm_reference(x, terms, scales, weight, bias, eps)
    elif x.device.type == "cuda":
        _kernel_checks(x, terms, weight, bias)
        out = _launch(x, terms, scales, weight, bias, eps)
        ADD_LN_LAUNCHES += 1
    else:
        raise ValueError(f"add_layer_norm runs on CUDA (kernel) or the CPU "
                         f"(plain version), not on {x.device}")
    ADD_LN_TERMS += len(terms)
    return out
