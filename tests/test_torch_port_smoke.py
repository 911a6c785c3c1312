"""The limits chip_smoke.py holds the RDB kernel to, checked on the CPU.

The CUDA kernel runs only on the card.  Here its arithmetic is emulated
in plain PyTorch (each launch's f32 sum rounded once to the storage
dtype, as the kernel stores it), and chip_smoke.py's own scoring must
pass that emulation and fail the same emulation with one launch made
wrong: its output left at zero, or its taps read mirrored.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchsr_tpu_torch.ops import rdb as rdb_ops

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SHAPE = (2, 8, 12, 64)
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(dtype):
    x = np.random.default_rng(7).normal(0, 0.5, SHAPE).astype(np.float32)
    ks, bs = smoke._rdb_weights(torch.Generator().manual_seed(7), "cpu")
    return (torch.from_numpy(x).to(dtype), [k.to(dtype) for k in ks], bs)


def _emulated_kernel(x, ks, bs, wrong_stage=None, fault=None):
    """The five launches of ``rdb_fwd.cu`` in plain PyTorch; launch
    ``wrong_stage`` optionally carries ``fault``."""
    dt = x.dtype
    feat = torch.zeros((*x.shape[:3], rdb_ops.FEAT), dtype=dt)
    feat[..., :rdb_ops.CHANNELS] = x
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        k = ks[i].float()
        if i == wrong_stage and fault == "mirrored_taps":
            k = k.flip(0, 1)
        acc = smoke.conv3x3(feat[..., :cin].float(), k, bs[i])
        if i == wrong_stage and fault == "zeros":
            acc = 0 * acc if i < 4 else None
        if i < 4:
            feat[..., cin:cin + cout] = F.leaky_relu(acc, 0.2).to(dt)
        elif acc is None:  # conv5 skipped: the block returns x
            out = x.clone()
        else:
            out = (x.float() + smoke.SCALE * acc).to(dt)
    return out, feat


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_limits_pass_the_kernels_rounding(dtype):
    x, ks, bs = _inputs(dtype)
    row = smoke.rdb_scores(x, ks, bs, *_emulated_kernel(x, ks, bs))
    assert max(row["stage_excess"]) <= 1, row
    assert row["block_excess"] <= 1, row
    assert min(row["stage_wrong_excess"]) > 1, row
    assert min(row["block_wrong_excess"].values()) > 1, row


@pytest.mark.parametrize("fault", ["zeros", "mirrored_taps"])
@pytest.mark.parametrize("stage", range(5))
def test_limits_catch_one_wrong_launch(stage, fault):
    x, ks, bs = _inputs(torch.bfloat16)
    out, feat = _emulated_kernel(x, ks, bs, stage, fault)
    row = smoke.rdb_scores(x, ks, bs, out, feat)
    assert row["stage_excess"][stage] > 1, row
    assert row["block_excess"] > 1, row


def test_kernel_path_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only; the CPU goes through
    ``fused_rdb``'s plain version."""
    x, ks, bs = _inputs(torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        rdb_ops.rdb_fwd_cuda(x, ks, bs)
