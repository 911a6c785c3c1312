"""The port's ESRGAN generator against the JAX package's.

The JAX generator is initialised from a fixed key; its variables cross
to the port through ``from_jax_variables``; both run the same numpy
input with ``train=False`` in f32 on the CPU.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxGenerator
from torchsr_tpu.models.torch_compat import export_esrgan_generator
from torchsr_tpu.ops.resize import nearest_upsample as jax_nearest
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.torch_compat import (
    from_jax_variables,
    strip_ddp_prefix,
    unwrap_state_dict,
)
from torchsr_tpu_torch.ops.resize import nearest_upsample
from torchsr_tpu_torch.registry import select_test_model

# f32 through 2 RRDBs (30 convs) and the tail, other summation orders;
# a 1-RRDB version measured 7.8e-8.
ATOL = 1e-5


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_model():
    gen = JaxGenerator(num_rrdb_blocks=2)
    x = np.random.default_rng(0).random((2, 16, 20, 3), dtype=np.float32)
    variables = gen.init(jax.random.PRNGKey(11), jnp.asarray(x), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    out = np.asarray(gen.apply(variables, jnp.asarray(x), train=False))
    return variables, x, out


def _port(state_dict, **kw):
    n = len({k.split(".")[1] for k in state_dict if k.startswith("blocks.")})
    gen = ESRGANGenerator(num_rrdb_blocks=n, device="meta", **kw)
    gen.load_state_dict(state_dict, assign=True)
    return gen.requires_grad_(False)


def test_from_jax_variables_matches_export(jax_model):
    variables = jax_model[0]
    ours = from_jax_variables(variables)
    theirs = export_esrgan_generator(variables)
    assert list(ours) == list(theirs)
    for key in ours:
        assert ours[key].dtype == torch.float32
        torch.testing.assert_close(ours[key], theirs[key], rtol=0, atol=0)
    # the params tree alone is accepted too
    assert from_jax_variables(variables["params"]).keys() == ours.keys()


def test_generator_matches_jax(jax_model):
    variables, x, want = jax_model
    torch.backends.cudnn.allow_tf32 = False
    gen = _port(from_jax_variables(variables))
    with torch.inference_mode():
        got = gen(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # outside inference mode (no kernel cache) the same numbers
    with torch.no_grad():
        again = gen(torch.from_numpy(x))
    np.testing.assert_allclose(again.numpy(), want, rtol=0, atol=ATOL)


def test_state_dict_is_the_reference_layout(jax_model):
    sd = ESRGANGenerator(num_rrdb_blocks=2, device="meta").state_dict()
    assert list(sd) == list(export_esrgan_generator(jax_model[0]))
    for key in ("conv1.weight", "blocks.1.RDB3.conv4.0.bias",
                "blocks.0.RDB1.conv5.weight", "conv3.0.weight",
                "upsample2.weight", "conv4.bias"):
        assert key in sd
    assert tuple(sd["blocks.0.RDB2.conv5.weight"].shape) == (64, 192, 3, 3)


def test_full_width_parameter_count():
    gen = ESRGANGenerator(device="meta")
    assert gen.num_rrdb_blocks == 23
    assert sum(p.numel() for p in gen.parameters()) == 16_697_987


def test_init_is_seeded_and_follows_the_reference():
    def make(seed):
        return ESRGANGenerator(num_rrdb_blocks=1,
                               generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        assert not torch.equal(va, vc), k
    # RDB kernels: kaiming-normal x 0.1 (std 0.1 * sqrt(2 / fan_in))
    w = a.blocks[0].RDB1.conv5.weight.detach()
    assert abs(float(w.std()) / (0.1 * (2 / (9 * 192)) ** 0.5) - 1) < 0.05
    # the rest: torch defaults, uniform(+-1/sqrt(fan_in))
    w1 = a.conv1.weight.detach()
    bound = 1 / 27 ** 0.5
    assert float(w1.abs().max()) <= bound
    assert float(w1.abs().max()) > 0.9 * bound


def test_scale_two_generator_matches_jax():
    gen = JaxGenerator(num_rrdb_blocks=1, scale_factor=2)
    x = np.random.default_rng(2).random((1, 8, 12, 3), dtype=np.float32)
    variables = jax.tree.map(np.asarray, dict(
        gen.init(jax.random.PRNGKey(5), jnp.asarray(x), train=False)))
    want = np.asarray(gen.apply(variables, jnp.asarray(x), train=False))
    port = _port(from_jax_variables(variables), scale_factor=2)
    assert port.upsamplers() == [port.upsample1]
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 16, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_nearest_upsample_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jax_nearest(jnp.asarray(x), 2))
    got = nearest_upsample(torch.from_numpy(x), 2)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_state_dict_wrappers_are_taken_off():
    w = torch.zeros(1)
    assert strip_ddp_prefix({"module.conv1.weight": w, "conv2.bias": w}) \
        .keys() == {"conv1.weight", "conv2.bias"}
    assert unwrap_state_dict(
        {"params_ema": {"module.a": w}, "params": {"b": w}}
    ).keys() == {"a"}


def test_from_jax_variables_rejects_stacked_scan_params(jax_model):
    """A stacked ``blocks_scan`` tree (the JAX ``--fast-compile``
    layout, made by the JAX package's ``stack_blocks``) now loads, equal
    to the unrolled one."""
    from torchsr_tpu.models.scan_compat import stack_blocks

    variables = jax_model[0]
    stacked = {"params": jax.tree.map(
        np.asarray, stack_blocks(variables["params"]))}
    assert "blocks_scan" in stacked["params"]
    want = from_jax_variables(variables)
    got = from_jax_variables(stacked)
    assert list(got) == list(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize(
    "model, error",
    [("ESRGAN", None), ("esrgan", None), ("srgan", None),
     ("edsr", "not supported")],
    # the ids are the ones this test has had since SRGAN (A9) was refused
    ids=["ESRGAN-None", "esrgan-None", "srgan-A9", "edsr-not supported"],
)
def test_registry(model, error):
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    args = argparse.Namespace(model=model)
    if error is None:
        want = SRGANGenerator if model == "srgan" else ESRGANGenerator
        assert select_test_model(args) is want
    else:
        with pytest.raises(RuntimeError, match=error):
            select_test_model(args)
