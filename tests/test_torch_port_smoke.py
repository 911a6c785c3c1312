"""The limits chip_smoke.py holds the RDB kernels to, checked on the CPU.

The CUDA kernels run only on the card.  Here their arithmetic is
emulated in plain PyTorch (the forward: each launch's f32 sum rounded
once to the storage dtype, as the kernel stores it; the backward:
chip_smoke.py's own ``emulated_bwd``), and chip_smoke.py's scoring must
pass that emulation and fail the same emulation with a fault put in:
a forward launch left at zero or with its taps mirrored; a backward
with one conv's dW left at zero, LeakyReLU' taken as 1, the dgrad taps
not flipped, or conv5's dense gradient not passed to convs 1-4.
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


def _bwd_inputs(dtype, shape=SHAPE):
    x, ks, bs = _inputs(dtype)
    x = x[:shape[0], :shape[1], :shape[2]]
    g = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.1, x.shape).astype(np.float32)).to(dtype)
    _, feat = rdb_ops._rdb_plain(x, ks, bs, smoke.SCALE)
    return g, feat, ks


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_emulation_is_the_plain_backward(dtype):
    g, feat, ks = _bwd_inputs(dtype)
    got = smoke.emulated_bwd(g, feat, ks, smoke.SCALE)
    want = rdb_ops.rdb_bwd_reference(g, feat, ks, smoke.SCALE,
                                     return_dfeat=True)
    for a, b in zip((got[0], *got[1], *got[2], got[3]),
                    (want[0], *want[1], *want[2], want[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [SHAPE, (1, 5, 7, 64)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_limits_pass_the_kernels_arithmetic(dtype, shape):
    g, feat, ks = _bwd_inputs(dtype, shape)
    row = smoke.bwd_scores(g, feat, ks,
                           smoke.emulated_bwd(g, feat, ks, smoke.SCALE))
    assert smoke._worst(row) <= 1, row


@pytest.mark.parametrize("fault", smoke.WRONG_BWD)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_limits_catch_each_wrong_kernel(dtype, fault):
    g, feat, ks = _bwd_inputs(dtype)
    row = smoke.bwd_scores(g, feat, ks, smoke.emulated_bwd(
        g, feat, ks, smoke.SCALE, fault))
    assert smoke._worst(row) > 1, row


def test_train_grad_limit_catches_a_wrong_backward():
    """The generator-gradient comparison of chip_smoke.py's train_grad
    phase, on the CPU at 1 RRDB: the plain path through the Function
    (plain backward) is within the f32 limit of autograd through
    ``rdb_reference``; the wrong backward (LeakyReLU' as 1) is not."""
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    gen = ESRGANGenerator(num_rrdb_blocks=1,
                          generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 8, 8, 3), generator=g)
    hr = torch.rand((2, 32, 32, 3), generator=g)
    params = list(gen.parameters())

    def grads(fn):
        return torch.autograd.grad((fn(x) - hr).abs().mean(), params)

    def wrong(y, kernels, biases, *, scale_ratio):
        return smoke._WrongBwdBlock.apply(y, "lrelu_one", *kernels, *biases)

    ref = grads(lambda t: smoke.plain_generator(gen, t))
    limit = smoke.TOL_GRAD[torch.float32]
    assert max(smoke._rel_grads(grads(gen), ref)) <= limit
    assert max(smoke._rel_grads(
        grads(lambda t: smoke.plain_generator(gen, t, wrong)), ref)) > limit


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::tensor_core::conv3x3_bf16<64, 32, false>"
     "(...)", "rdb_fwd"),
    ("void (anonymous namespace)::tensor_core::wgrad_bf16<192, 64>(...)",
     "rdb_bwd"),
    ("void (anonymous namespace)::reduce_partials(...)", "rdb_bwd"),
    ("void (anonymous namespace)::prep<4, __nv_bfloat16>(...)", "rdb_bwd"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
     "<...>(...)", "optimizer"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "other_conv"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
])
def test_profile_kernel_classes(name, cls):
    assert smoke._kernel_class(name) == cls
