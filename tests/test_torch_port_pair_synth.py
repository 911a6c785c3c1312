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
from torchsr_tpu_torch.data.preprocess import synthesize_pair
from torchsr_tpu_torch.ops import preprocess as ps_ops
from torchsr_tpu_torch.ops.preprocess import synthesize_pair_cuda
from torchsr_tpu_torch.tools import bench_preprocess

LR_ATOL = 1 / 255 + 1e-6
LR_FRACTION = 1e-3


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


EVERY_FLIP = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=bool)


@pytest.mark.parametrize("size", [96, 128, 100])
def test_bands_match_the_plain_version_and_the_pallas_kernel(size):
    """The kernel's data flow, band by band of ``pair_plan`` (each band
    reading only its window's HR rows, writing its share of hr and its LR
    rows), gives HR and LR bit-equal to the plain version, with every
    flip; and matches the Pallas kernel in interpret mode as
    ``test_matches_the_pallas_kernel`` does (HR bit for bit, LR within
    one level at <= 0.1% of values).  Four crops make 32 bands a crop at
    96 and 128 px and 25 (one an LR row) at 100 px."""
    crops, _ = _inputs(4, size, size)
    ct, ft = torch.from_numpy(crops), torch.from_numpy(EVERY_FLIP)
    lr, hr = ps_ops.synthesize_pair_bands_reference(ct, ft)
    want_lr, want_hr = synthesize_pair(ct, ft)
    assert torch.equal(hr, want_hr) and torch.equal(lr, want_lr)
    p_lr, p_hr = (np.asarray(a) for a in synthesize_pair_pallas(
        crops, EVERY_FLIP, interpret=True))
    np.testing.assert_array_equal(hr.numpy(), p_hr)
    diff = np.abs(lr.numpy() - p_lr)
    assert float(diff.max()) <= LR_ATOL
    assert float((diff > 0).mean()) <= LR_FRACTION


@pytest.mark.parametrize("batch", [1, 5, 64, 256])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 37, 96, 100, 128, 148])
def test_pair_plan_cuts_each_image_into_bands(size, batch):
    """The bands cut the LR rows, and their shares hr's rows, each row
    once; each band's window holds its share and the rows its taps read;
    the largest window sizes the shared memory; a call makes about
    BAND_CTAS CTAs, at least one an image and at most one an LR row."""
    s = size // 4
    nb = ps_ops.pair_bands(batch, s)
    assert 1 <= nb <= s
    assert nb == s or batch * nb >= ps_ops.BAND_CTAS
    assert nb == 1 or batch * (nb - 1) < ps_ops.BAND_CTAS
    plan = ps_ops.pair_plan(size, s, nb)
    bands = plan["bands"]
    assert len(bands) == nb
    assert [r for o0, o1, *_ in bands for r in range(o0, o1)] == list(range(s))
    assert [r for *_, h0, h1, _, _ in bands
            for r in range(h0, h1)] == list(range(size))
    for o0, o1, w0, w1, h0, h1, t0, t1 in bands:
        assert 0 <= w0 <= min(h0, t0) and max(h1, t1) <= w1 <= size
        for lo, hi in plan["band"][o0:o1]:
            assert t0 <= lo and hi <= t1
    assert plan["rows"] == max(w1 - w0 for _, _, w0, w1, *_ in bands)
    n_taps = plan["taps"].shape[0]
    assert plan["smem"] == (n_taps * s + 3 * plan["rows"] * s + 2 * s) * 4 \
        + 3 * plan["rows"] * size


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
