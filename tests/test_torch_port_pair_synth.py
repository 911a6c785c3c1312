"""The port's fused pair synthesis (B3) against the JAX package's.

On the CPU ``synthesize_pair_cuda`` runs its plain version; the same
seeded numpy crops and flips go through the JAX package's Pallas kernel
in interpret mode.  HR must be equal bit for bit (one f32 product per
value in both); LR may differ by one uint8 level where an f32 sum taken
in another order lands on the other side of a quantization tie, at no
more than 0.1% of the values.  The CUDA kernel itself is held to the
same limits on the card by chip_smoke.py.
"""

import json

import numpy as np
import pytest
import torch

from torchsr_tpu.ops.pallas.preprocess import synthesize_pair_pallas
from torchsr_tpu_torch.ops.preprocess import synthesize_pair_cuda
from torchsr_tpu_torch.tools import bench_preprocess

LR_ATOL = 1 / 255 + 1e-6
LR_FRACTION = 1e-3


def _inputs(b, s, seed, flips=True):
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    bits = (rng.random((b, 2)) < 0.5 if flips
            else np.zeros((b, 2), dtype=bool))
    return crops, bits


@pytest.mark.parametrize("b, s, seed, flips", [(4, 32, 0, True),
                                               (2, 64, 1, False)])
def test_matches_the_pallas_kernel(b, s, seed, flips):
    crops, bits = _inputs(b, s, seed, flips)
    want_lr, want_hr = (np.asarray(a) for a in synthesize_pair_pallas(
        crops, bits, interpret=True))
    lr, hr = synthesize_pair_cuda(torch.from_numpy(crops),
                                  torch.from_numpy(bits))
    assert hr.shape == (b, s, s, 3) and lr.shape == (b, s // 4, s // 4, 3)
    assert hr.dtype == lr.dtype == torch.float32
    np.testing.assert_array_equal(hr.numpy(), want_hr)
    diff = np.abs(lr.numpy() - want_lr)
    assert float(diff.max()) <= LR_ATOL
    assert float((diff > 0).mean()) <= LR_FRACTION


def test_returns_lr_then_hr_with_each_flip():
    """(lr, hr), as the JAX wrapper swaps the kernel's (hr, lr); column 0
    reverses W, column 1 reverses H."""
    crops, _ = _inputs(3, 16, 2)
    bits = np.array([[1, 0], [0, 1], [1, 1]], dtype=bool)
    lr, hr = synthesize_pair_cuda(torch.from_numpy(crops),
                                  torch.from_numpy(bits), upscale_factor=2)
    assert lr.shape == (3, 8, 8, 3)
    x = crops.astype(np.float32) * np.float32(1 / 255)
    np.testing.assert_array_equal(hr[0].numpy(), x[0, :, ::-1])
    np.testing.assert_array_equal(hr[1].numpy(), x[1, ::-1])
    np.testing.assert_array_equal(hr[2].numpy(), x[2, ::-1, ::-1])


def test_refuses_what_the_kernel_does_not_take():
    crops = torch.zeros((2, 16, 12, 3), dtype=torch.uint8)
    flips = torch.zeros((2, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="square"):
        synthesize_pair_cuda(crops, flips)
    with pytest.raises(TypeError, match="uint8"):
        synthesize_pair_cuda(torch.zeros((2, 16, 16, 3)), flips)
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        synthesize_pair_cuda(torch.zeros((2, 16, 16, 3), dtype=torch.uint8),
                             flips[:1])
    # a device that is neither the CPU (plain version) nor CUDA (kernel)
    meta = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        synthesize_pair_cuda(meta, flips.to("meta"))


def test_bench_tool_runs_on_the_cpu(capsys):
    rows = bench_preprocess.main(["--device", "cpu", "--batch", "2",
                                  "--crop", "32", "--steps", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["path"] for r in lines] == ["plain", "kernel"]
    assert lines[0]["shape"] == [2, 32, 32, 3]
    assert all(r["median_us"] > 0 and r["p90_us"] > 0 for r in lines)
    assert set(rows) == {"plain", "kernel"}


def test_bench_tool_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_preprocess.main(["--steps", "1"])
