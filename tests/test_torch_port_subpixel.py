"""The port's subpixel-space convolution against the JAX package's.

Every function of ``torchsr_tpu_torch/ops/subpixel_conv.py`` against
its namesake in ``torchsr_tpu/ops/subpixel_conv.py`` at r = 2, 4 and 8
on inputs made from a numpy seed, forward and gradients, f32, rel 1e-5
(the JAX kernels are HWIO, the port's OIHW: the test transposes); the
subpixel forms against the direct conv; and the SRGAN / ESRGAN
generators with their subpixel heads on and off, against each other
and against the JAX generators, with the same ``state_dict`` keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxESRGAN
from torchsr_tpu.models.srgan import SRGANGenerator as JaxSRGAN
from torchsr_tpu.ops import subpixel_conv as jsc
from torchsr_tpu.ops.pixel_shuffle import depth_to_space as jax_d2s
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.srgan import SRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.ops import subpixel_conv as psc

RTOL, ATOL = 1e-5, 1e-6
# the generators: f32 through the trunk, and the head as the other
# summation order of the same products (tests/test_torch_port_srgan.py
# holds the direct head against JAX's fused one at 2e-5)
ATOL_GEN = 2e-5
CASES = [(9, 2), (9, 4), (9, 8), (3, 2), (3, 4), (3, 8)]


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _hwio(w_oihw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_oihw.transpose(2, 3, 1, 0))


def _direct(x, w, b):
    """The direct SAME conv (NHWC, OIHW) the subpixel forms equal."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("k,r", CASES)
def test_phase_indices_match_jax(k, r):
    taps, idx, valid, pad = psc._phase_indices(k, r)
    jtaps, jidx, jvalid, jpad = jsc._phase_indices(k, r)
    assert (taps, pad) == (jtaps, jpad)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(valid.numpy(), jvalid)


@pytest.mark.parametrize("k,r,g", [(9, 4, 2), (9, 8, 2), (9, 8, 4),
                                   (3, 4, 2), (3, 2, 2)])
def test_partial_fold_indices_match_jax(k, r, g):
    got = psc._partial_fold_indices(k, r, g)
    want = jsc._partial_fold_indices(k, r, g)
    assert (got[0], got[3]) == (want[0], want[3])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("k,r", CASES)
def test_subpixel_space_kernel_matches_jax(k, r):
    w = _rng(k * r).standard_normal((3, 5, k, k)).astype(np.float32)
    kernel, pad = psc.subpixel_space_kernel(torch.from_numpy(w), r)
    jkernel, jpad = jsc.subpixel_space_kernel(jnp.asarray(_hwio(w)), r)
    assert pad == jpad
    np.testing.assert_array_equal(
        kernel.numpy(), np.asarray(jkernel).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("k,r,g", [(9, 4, 2), (9, 8, 4), (3, 4, 2)])
def test_partial_fold_kernel_matches_jax(k, r, g):
    w = _rng(k + r + g).standard_normal((3, 4, k, k)).astype(np.float32)
    kernel, pad, stride = psc.partial_fold_kernel(torch.from_numpy(w), r, g)
    jkernel, jpad, jstride = jsc.partial_fold_kernel(
        jnp.asarray(_hwio(w)), r, g)
    assert (pad, stride) == (jpad, jstride)
    np.testing.assert_array_equal(
        kernel.numpy(), np.asarray(jkernel).transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="divisible"):
        psc.partial_fold_kernel(torch.from_numpy(w), 4, 3)


def _grads_both(fn_port, fn_jax, x, w, b, cot):
    """Output and (dx, dw, db) of the port's function (OIHW) and JAX's
    (HWIO) under the same output cotangent."""
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, b))
    out = fn_port(xt, wt, bt)
    out.backward(torch.from_numpy(cot))
    jout, vjp = jax.vjp(fn_jax, jnp.asarray(x), jnp.asarray(_hwio(w)),
                        jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(cot))
    got = (out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(),
           bt.grad.numpy())
    want = (np.asarray(jout), np.asarray(jdx),
            np.asarray(jdw).transpose(3, 2, 0, 1), np.asarray(jdb))
    return got, want


def _assert_all_close(got, want, what):
    for name, a, b in zip(("out", "dx", "dw", "db"), got, want):
        assert a.shape == b.shape, (what, name)
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(b).max()),
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("k,r", CASES)
def test_conv_subpixel_space_matches_jax_and_direct(k, r):
    rng = _rng(100 + k * r)
    x = rng.random((2, 3 * r, 2 * r, 4), np.float32)
    w = rng.standard_normal((3, 4, k, k)).astype(np.float32) * 0.1
    b = rng.standard_normal(3).astype(np.float32)
    cot = rng.standard_normal((2, 3 * r, 2 * r, 3)).astype(np.float32)
    got, want = _grads_both(
        lambda xt, wt, bt: psc.conv_subpixel_space(xt, wt, bt, r),
        lambda xj, wj, bj: jsc.conv_subpixel_space(xj, wj, bj, r),
        x, w, b, cot)
    _assert_all_close(got, want, f"conv_subpixel_space k={k} r={r}")
    direct = _direct(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got[0], direct.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k,r,g", [(9, 4, 2), (9, 8, 2), (3, 4, 2)])
def test_conv_head_partially_folded_matches_jax_and_direct(k, r, g):
    rng = _rng(200 + k * r * g)
    h, w_ = 3 * r // g, 2 * r // g
    y = rng.random((2, h, w_, 4 * g * g), np.float32)
    w = rng.standard_normal((3, 4, k, k)).astype(np.float32) * 0.1
    b = rng.standard_normal(3).astype(np.float32)
    cot = rng.standard_normal((2, h * g, w_ * g, 3)).astype(np.float32)
    got, want = _grads_both(
        lambda yt, wt, bt: psc.conv_head_partially_folded(yt, wt, bt, r, g),
        lambda yj, wj, bj: jsc.conv_head_partially_folded(yj, wj, bj, r, g),
        y, w, b, cot)
    _assert_all_close(got, want, f"partially folded k={k} r={r} g={g}")
    hr = torch.from_numpy(np.array(jax_d2s(jnp.asarray(y), g)))
    direct = _direct(hr, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got[0], direct.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_srgan_fused_head_on_and_off(scale):
    """The SRGAN generator with ``fused_head`` on (4x: the partially
    folded head) and off: the same ``state_dict`` keys, outputs and
    parameter gradients; with it on, equal to the JAX generator's fused
    head."""
    jg = JaxSRGAN(num_residual=1, scale_factor=scale)
    x = _rng(scale).random((2, 6, 5, 3), np.float32)
    variables = jax.tree.map(np.asarray, dict(jg.init(
        jax.random.PRNGKey(scale), jnp.asarray(x), train=False)))
    want = np.asarray(jg.apply(variables, jnp.asarray(x), train=False))
    sd = from_jax_variables(variables)
    outs, grads = [], []
    for fused in (True, False):
        gen = SRGANGenerator(num_residual=1, scale_factor=scale,
                             fused_head=fused, device="meta")
        gen.load_state_dict(sd, assign=True)
        gen.eval()
        assert set(gen.state_dict()) == set(sd)
        out = gen(torch.from_numpy(x))
        out.square().sum().backward()
        outs.append(out.detach().numpy())
        grads.append({n: p.grad.numpy() for n, p in gen.named_parameters()})
    assert outs[0].shape == (2, 6 * scale, 5 * scale, 3)
    np.testing.assert_allclose(outs[0], want, atol=ATOL_GEN, rtol=0)
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL_GEN, rtol=0)
    for name, g in grads[0].items():
        np.testing.assert_allclose(
            g, grads[1][name], rtol=1e-4,
            atol=1e-5 * max(1.0, np.abs(grads[1][name]).max()),
            err_msg=name)


@pytest.mark.parametrize("scale", [2, 4])
def test_esrgan_fused_tail_on_and_off(scale):
    jg = JaxESRGAN(num_rrdb_blocks=1, scale_factor=scale)
    x = _rng(10 + scale).random((2, 6, 5, 3), np.float32)
    variables = jax.tree.map(np.asarray, dict(jg.init(
        jax.random.PRNGKey(scale), jnp.asarray(x), train=False)))
    want = np.asarray(jg.apply(variables, jnp.asarray(x), train=False))
    sd = from_jax_variables(variables)
    outs = []
    for fused in (True, False):
        gen = ESRGANGenerator(num_rrdb_blocks=1, scale_factor=scale,
                              fused_tail=fused, device="meta")
        gen.load_state_dict(sd, assign=True)
        assert set(gen.state_dict()) == set(sd)
        with torch.no_grad():
            outs.append(gen(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(outs[0], want, atol=ATOL_GEN, rtol=0)
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL_GEN, rtol=0)


def test_heads_default_to_the_direct_conv_on_the_cpu():
    """``None`` picks the direct conv for a CPU tensor (the subpixel form
    is the CUDA default where it measured faster)."""
    x = torch.zeros(1, 4, 4, 64)
    assert not SRGANGenerator(num_residual=1, device="meta") \
        .uses_fused_head(x)
    gen = ESRGANGenerator(num_rrdb_blocks=1)
    torch.testing.assert_close(gen.head(x), gen.conv4(x))
