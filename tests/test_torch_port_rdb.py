"""The port's residual dense block against the JAX package's Pallas kernel.

On the CPU ``torchsr_tpu_torch.ops.rdb.fused_rdb`` runs its plain
PyTorch version; the JAX side runs the Pallas TPU kernel in interpret
mode, as tests/test_pallas_rdb.py does.  Inputs come from numpy with a
seed; everything is f32.  The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models.esrgan import ResidualDenseBlock as JaxRDB
from torchsr_tpu.ops.pallas.rdb import fused_rdb as jax_fused_rdb
from torchsr_tpu_torch.models.esrgan import ResidualDenseBlock
from torchsr_tpu_torch.ops import _build
from torchsr_tpu_torch.ops import rdb as rdb_ops
from torchsr_tpu_torch.utils.compile_cache import kernel_build_dir

# f32 on both sides, summed in other orders: measured ~2e-7.
ATOL = 1e-5


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    params = JaxRDB().init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ks = [np.asarray(params["params"][f"conv{i}"]["conv"]["kernel"])
          for i in range(1, 6)]
    # nonzero biases, so a pixel leaking across an image edge shows
    bs = [rng.normal(0, 0.1, (k.shape[-1],)).astype(np.float32)
          for k in ks]
    return x, ks, bs


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize(
    "shape",
    # W=12 and odd 7x9 are not multiples of the CUDA kernel's 8x16
    # tile; (4, 4, 8) puts several images in one TPU block
    [(2, 8, 12, 64), (1, 7, 9, 64), (4, 4, 8, 64)],
)
def test_fused_rdb_matches_pallas_interpret(shape):
    x, ks, bs = _weights(shape, seed=sum(shape))
    want = np.asarray(jax_fused_rdb(jnp.asarray(x), ks, bs, interpret=True))
    torch.backends.cudnn.allow_tf32 = False
    before = rdb_ops.RDB_FWD_LAUNCHES
    got = rdb_ops.fused_rdb(torch.from_numpy(x), _t(ks), _t(bs))
    assert rdb_ops.RDB_FWD_LAUNCHES == before  # the CPU runs no kernel
    assert got.shape == x.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scale_ratio", [0.2, 0.5])
def test_scale_ratio_matches_pallas_interpret(scale_ratio):
    x, ks, bs = _weights((1, 6, 8, 64), seed=3)
    want = np.asarray(jax_fused_rdb(jnp.asarray(x), ks, bs,
                                    scale_ratio=scale_ratio,
                                    interpret=True))
    got = rdb_ops.fused_rdb(torch.from_numpy(x), _t(ks), _t(bs),
                            scale_ratio=scale_ratio)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_module_repacks_after_weight_update():
    """The inference-mode cache of HWIO kernels follows in-place
    weight updates (keyed on the version counter)."""
    rdb = ResidualDenseBlock()
    g = torch.Generator().manual_seed(0)
    for conv in rdb.convs():
        conv.reset_parameters(g)
    x = torch.randn((1, 5, 6, 64), generator=g)

    def plain():
        convs = rdb.convs()
        return rdb_ops.rdb_reference(
            x, [c.weight.permute(2, 3, 1, 0) for c in convs],
            [c.bias for c in convs])

    with torch.inference_mode():
        first = rdb(x)
    torch.testing.assert_close(first, plain().detach())
    with torch.no_grad():
        rdb.conv3[0].weight.mul_(3.0)
    with torch.inference_mode():
        second = rdb(x)
    torch.testing.assert_close(second, plain().detach())
    assert (second - first).abs().max() > 1e-4


@pytest.mark.parametrize(
    "bad",
    ["channels", "rank", "kernel_shape", "bias_shape", "count"],
)
def test_fused_rdb_rejects_malformed_inputs(bad):
    x, ks, bs = _weights((1, 4, 4, 64), seed=1)
    x, ks, bs = torch.from_numpy(x), _t(ks), _t(bs)
    if bad == "channels":
        x = x[..., :32]
    elif bad == "rank":
        x = x[0]
    elif bad == "kernel_shape":
        ks[2] = ks[2][:, :, :64]
    elif bad == "bias_shape":
        bs[4] = bs[4][:32]
    else:
        ks = ks[:4]
    with pytest.raises(ValueError):
        rdb_ops.fused_rdb(x, ks, bs)


def test_fused_rdb_refuses_other_devices():
    """Only CUDA (kernel) and CPU (plain version) are served; there is
    no silent fallback for any other device."""
    x = torch.empty((1, 4, 4, 64), device="meta")
    ks = [torch.empty((3, 3, ci, co), device="meta")
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    bs = [torch.empty((co,), device="meta") for co in rdb_ops.COUT]
    with pytest.raises(ValueError, match="CUDA"):
        rdb_ops.fused_rdb(x, ks, bs)


def test_kernel_sources_export_the_bound_symbols():
    """Every C entry point the ctypes loader binds is defined, with the
    argument count declared, in the source it builds."""
    for name, functions in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "sm_90a" in (" ".join(_build.NVCC_FLAGS))
        for fn, (_, argtypes) in functions.items():
            m = re.search(rf"\b{fn}\(([^)]*)\)\s*{{", src)
            assert m, f"{fn} not defined in {name}.cu"
            assert len(m.group(1).split(",")) == len(argtypes)
        path = _build.library_path(name)
        assert path.parent == kernel_build_dir()
        assert path == _build.library_path(name)  # content-addressed
