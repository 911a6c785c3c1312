"""Residual dense block (RDB) forward: CUDA kernel and plain version.

``fused_rdb`` is the PyTorch counterpart of the JAX package's
``torchsr_tpu/ops/pallas/rdb.py`` ``fused_rdb`` (its TPU kernel
``_rdb_fwd_kernel``, rdb.py:142), with the same layouts: NHWC
activations (B, H, W, 64), five HWIO kernels (3, 3, C_in, C_out) with
C_in = 64 + 32 i, and five biases.  It computes
``x + scale_ratio * conv5(dense(x))``, where ``dense`` grows the
64-channel input by 32 LeakyReLU(0.2) channels per conv.

A CUDA tensor runs the hand-written kernel ``csrc/rdb_fwd.cu`` (design
and bound in its header): one NHWC (B, H, W, 192) feature buffer holds x
and the four grown slices, and one direct-conv kernel is launched five
times, accumulating in f32 and storing in the working dtype (f32, or
bf16 under AMP).  Biases stay f32, as the TPU kernel keeps them.  A CPU
tensor runs ``rdb_reference``, the plain PyTorch version.  There is no
fallback: on CUDA the kernel runs or the call raises.

Forward only: the backward kernel (ROADMAP B2) comes with training, so a
CUDA call that autograd would record raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHANNELS = 64
CIN = (64, 96, 128, 160, 192)
COUT = (32, 32, 32, 32, 64)
FEAT = CIN[-1]

# Kernel launches by ``fused_rdb`` on CUDA: five per block.  A run reads
# it to show that its path went through the kernel.
RDB_FWD_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z, which carries the batch


def _check(x: torch.Tensor, kernels, biases) -> None:
    if x.dim() != 4 or x.shape[-1] != CHANNELS:
        raise ValueError(
            f"fused_rdb expects NHWC x of shape (B, H, W, {CHANNELS}), "
            f"got {tuple(x.shape)}"
        )
    if len(kernels) != 5 or len(biases) != 5:
        raise ValueError("fused_rdb expects five kernels and five biases")
    for i, (k, b) in enumerate(zip(kernels, biases)):
        if tuple(k.shape) != (3, 3, CIN[i], COUT[i]):
            raise ValueError(
                f"kernel {i + 1} must be HWIO (3, 3, {CIN[i]}, "
                f"{COUT[i]}), got {tuple(k.shape)}"
            )
        if tuple(b.shape) != (COUT[i],):
            raise ValueError(
                f"bias {i + 1} must be ({COUT[i]},), got {tuple(b.shape)}"
            )


def rdb_reference(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> torch.Tensor:
    """The plain version: five ``F.conv2d`` calls on the concatenated
    features, computed in ``x.dtype`` (the unfused flax block's math)."""
    _check(x, kernels, biases)
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    feats = [xc]
    out = xc
    for i in range(5):
        w = kernels[i].permute(3, 2, 0, 1).to(dt)
        out = F.conv2d(torch.cat(feats, dim=1), w, biases[i].to(dt),
                       padding=1)
        if i < 4:
            feats.append(F.leaky_relu(out, 0.2))
    return (out * scale_ratio + xc).permute(0, 2, 3, 1).contiguous()


def fused_rdb(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> torch.Tensor:
    """Residual dense block ``x + scale_ratio * conv5(dense(x))``.

    ``x``: (B, H, W, 64) NHWC, f32 or bf16.  ``kernels``: five HWIO
    (3, 3, C_in, C_out) kernels; ``biases``: five (C_out,) vectors.  On
    CUDA the kernels are used in ``x.dtype`` and the biases in f32."""
    if x.device.type == "cpu":
        return rdb_reference(x, kernels, biases, scale_ratio=scale_ratio)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_rdb runs on CUDA (kernel) or CPU (plain version), "
            f"not on {x.device}"
        )
    return rdb_fwd_cuda(x, kernels, biases, scale_ratio=scale_ratio)[0]


def rdb_fwd_cuda(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel path of ``fused_rdb`` on a CUDA ``x``.  Returns the
    block output and the (B, H, W, 192) feature buffer the five launches
    filled (x, then the four grown 32-channel slices), so that each
    launch can be held against its own convolution."""
    global RDB_FWD_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    if x.device.type != "cuda":
        raise ValueError(f"rdb_fwd_cuda runs on CUDA, not on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_rdb takes float32 or bfloat16, not {x.dtype}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *kernels, *biases)
    ):
        raise NotImplementedError(
            "fused_rdb on CUDA is forward-only: its backward kernel is "
            "not ported yet (ROADMAP B2); run under torch.no_grad() or "
            "torch.inference_mode()"
        )
    if x.shape[0] > _MAX_GRID_Z:
        raise ValueError(
            f"fused_rdb takes at most {_MAX_GRID_Z} images per call, "
            f"got {x.shape[0]}"
        )
    for t in (*kernels, *biases):
        if t.device != x.device:
            raise ValueError(
                f"fused_rdb operands must share x's device {x.device}, "
                f"got one on {t.device}"
            )
    x = x.contiguous()
    # the kernel reads weights in 16-byte vectors: realign odd views
    kernels = [k.to(x.dtype).contiguous() for k in kernels]
    kernels = [k.clone() if k.data_ptr() % 16 else k for k in kernels]
    biases = [b.to(torch.float32).contiguous() for b in biases]
    b, h, w, _ = x.shape
    feat = torch.empty((b, h, w, FEAT), dtype=x.dtype, device=x.device)
    feat[..., :CHANNELS].copy_(x)
    out = torch.empty_like(x)

    lib = load_library("rdb_fwd")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = int(x.dtype == torch.bfloat16)
    for i in range(5):
        dst = out if i == 4 else feat
        err = lib.rdb_conv3x3_launch(
            i, is_bf16, feat.data_ptr(), kernels[i].data_ptr(),
            biases[i].data_ptr(), dst.data_ptr(), b, h, w,
            float(scale_ratio), x.device.index, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"rdb_fwd conv {i + 1} failed to launch: CUDA error {err} "
                f"({lib.rdb_error_string(err).decode()})"
            )
        RDB_FWD_LAUNCHES += 1
    return out, feat
