"""The port's 3x3 64 -> 64 conv (B4, B5) against the JAX package's.

On the CPU ``pair_conv`` runs its plain versions through the same
autograd Function the kernels use on CUDA; the same seeded numpy x,
kernel and bias go through the JAX package's pixel-pair Pallas kernels
in interpret mode, forward and custom-VJP backward.  Both compute f32
sums of the same products in other orders: the forward within 1e-5, the
gradients within rtol 1e-4 / atol 1e-5 (dW sums over every pixel).  The
CUDA kernels are held to per-element limits on the card by
chip_smoke.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.ops.pallas import pair_conv as jax_pc
from torchsr_tpu_torch.ops import pair_conv as pc
from torchsr_tpu_torch.tools import bench_pair_conv

# The JAX package's own test shapes (test_pallas_pair_conv.py:34): even
# widths, odd heights, W = 2 (every pixel at both edges), multi-image.
SHAPES = [(2, 8, 16, 64), (1, 12, 8, 64), (2, 5, 10, 64), (1, 3, 2, 64),
          (4, 4, 6, 64)]


def _inputs(shape, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, 64, 64)).astype(np.float32)
    b = rng.normal(0, 0.2, (64,)).astype(np.float32) if bias else None
    return x, k, b


def _jax(x, k, b):
    return np.asarray(jax_pc.pair_conv(
        jnp.asarray(x), jnp.asarray(k),
        None if b is None else jnp.asarray(b), interpret=True))


def _port(x, k, b):
    t = torch.from_numpy
    return pc.pair_conv(t(x), t(k), None if b is None else t(b)).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax(shape):
    x, k, b = _inputs(shape)
    np.testing.assert_allclose(_port(x, k, b), _jax(x, k, b), rtol=1e-5,
                               atol=1e-5)


def test_no_bias_matches_jax():
    x, k, _ = _inputs((2, 6, 8, 64), seed=1, bias=False)
    np.testing.assert_allclose(_port(x, k, None), _jax(x, k, None),
                               rtol=1e-5, atol=1e-5)


def test_multi_image_no_leak():
    """Each image of a batch equals the image alone: nothing crosses an
    image's edge."""
    x, k, b = _inputs((4, 4, 8, 64), seed=2)
    out = _port(x, k, b)
    for i in range(4):
        np.testing.assert_allclose(out[i:i + 1], _port(x[i:i + 1], k, b),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _jax(x, k, b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 6, 10, 64), (6, 4, 4, 64)], ids=str)
def test_gradients_match_the_jax_custom_vjp(shape):
    x, k, b = _inputs(shape, seed=3)
    g = np.random.default_rng(4).normal(0, 1, shape).astype(np.float32)

    def loss(x, k, b):
        return jnp.sum(jax_pc.pair_conv(x, k, b, interpret=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    (pc.pair_conv(*ts) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_backward_reference_keeps_the_precision_contract():
    """bf16: g rounded to bf16 first, dx in bf16, dW and db in f32 over
    the rounded g (an f32 kernel gets its gradient in f32)."""
    x, k, _ = _inputs((2, 4, 6, 64), seed=5)
    xb = torch.from_numpy(x).bfloat16()
    g = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, x.shape).astype(np.float32))
    dx, dw, db = pc.pair_conv_bwd_reference(xb, torch.from_numpy(k), g)
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float32)
    torch.testing.assert_close(db, g.bfloat16().float().sum(dim=(0, 1, 2)),
                               rtol=0, atol=0)
    kt = torch.from_numpy(k).requires_grad_()
    bt = torch.zeros(64, requires_grad=True)
    pc.pair_conv(xb, kt, bt).backward(g.bfloat16())
    torch.testing.assert_close(kt.grad, dw, rtol=0, atol=0)
    torch.testing.assert_close(bt.grad, db, rtol=0, atol=0)


@pytest.mark.parametrize("shape, kernel_shape", [
    ((2, 8, 16, 64), (3, 3, 64, 64)),
    ((1, 128, 256, 64), (3, 3, 64, 64)),   # 16384 pairs: the cap
    ((1, 129, 256, 64), (3, 3, 64, 64)),   # over it
    ((1, 4, 7, 64), (3, 3, 64, 64)),       # odd width
    ((1, 4, 8, 32), (3, 3, 64, 64)),       # 32 channels
    ((1, 4, 8, 64), (3, 3, 64, 32)),       # 64 -> 32
    ((1, 4, 8, 64), (5, 5, 64, 64)),       # 5x5
], ids=str)
def test_gate_matches_jax(shape, kernel_shape):
    want = jax_pc.pair_conv_supported(shape, kernel_shape)
    assert pc.pair_conv_supported(shape, kernel_shape) == want
    if not want:
        x = torch.zeros(shape)
        with pytest.raises(ValueError, match="pair_conv: unsupported "
                                             "shapes"):
            pc.pair_conv(x, torch.zeros(kernel_shape))


def test_conv_reference_matches_jax():
    x, k, b = _inputs((2, 5, 10, 64), seed=7)
    want = jax_pc.conv_reference(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(b))
    got = pc.conv_reference(torch.from_numpy(x), torch.from_numpy(k),
                            torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _port(x, k, b), rtol=1e-5,
                               atol=1e-5)


def test_kernel_paths_take_cuda_tensors_only():
    """The kernel wrappers refuse CPU tensors (``pair_conv`` sends those
    to the plain versions); ``pair_conv`` refuses other devices."""
    x, k, b = (torch.from_numpy(a) for a in _inputs((1, 4, 8, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        pc.pair_conv_fwd_cuda(x, k, b)
    with pytest.raises(ValueError, match="CUDA"):
        pc.pair_conv_bwd_cuda(x, k, x)
    with pytest.raises(ValueError, match="CUDA"):
        pc.pair_conv(x.to("meta"), k.to("meta"))


def test_wgrad_groups():
    """The wgrad's f32 partials: one per 8 x 32 pixel tile, at most
    132."""
    assert pc.wgrad_groups(128, 24, 24) == 132
    assert pc.wgrad_groups(3, 5, 10) == 3
    assert pc.wgrad_groups(1, 128, 256) == 128


def test_bench_tool_runs_on_the_cpu(capsys):
    rows = bench_pair_conv.main(["--device", "cpu", "--batch", "2", "--h",
                                 "4", "--w", "4"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["mode"] for r in lines] == ["fwd", "fwdbwd"]
    assert lines[0]["shape"] == [2, 4, 4, 64]
    assert all(r["kernel_us_per_conv"] and r["reference_us_per_conv"]
               for r in lines)
    assert set(rows) == {"fwd", "fwdbwd"}


def test_bench_tool_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_pair_conv.main(["--mode", "fwd"])
