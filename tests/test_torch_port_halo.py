"""The port's sharded inference against the monolithic forward, the
tiled path and the JAX package.

``infer/halo.py`` ``halo_upscale`` over a grid of (CPU) devices: exact
against the monolithic forward where the overlap covers the receptive
field, and equal to the JAX ``halo_upscale`` on the 8 virtual CPU
devices of tests/conftest.py (2 x 4 and 8 x 1 meshes), for a biased
toy conv and tiny SRGAN / ESRGAN generators; ``infer/multichip.py``
``tiled_upscale_sharded`` equal to ``tiled_upscale`` bit for bit and to
the JAX ``tiled_upscale_sharded``; ``pair_conv`` split over a device
list; and ``test --shard-tiles`` / ``--spatial-shard`` and a
``--shard-tiles`` service on the CPU.  Inputs come from numpy with a
seed; f32.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from torchsr_tpu.infer import halo as jax_halo
from torchsr_tpu.infer.multichip import (
    tiled_upscale_sharded as jax_tiled_sharded,
)
from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxESRGAN
from torchsr_tpu.models.srgan import SRGANGenerator as JaxSRGAN
from torchsr_tpu.ops.resize import nearest_upsample as jax_nearest
from torchsr_tpu.parallel.mesh import make_mesh, replicate
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.infer.halo import halo_upscale, make_spatial_mesh
from torchsr_tpu_torch.infer.multichip import (
    sharded_forwards,
    tiled_upscale_sharded,
)
from torchsr_tpu_torch.infer.server import CheckpointUpscaleService
from torchsr_tpu_torch.infer.tiled import tiled_upscale
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.srgan import SRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.ops.pair_conv import pair_conv
from torchsr_tpu_torch.ops.resize import nearest_upsample
from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

CPU = torch.device("cpu")
# the generators through other conv summation orders (JAX's own halo
# tests hold them at 2e-4)
ATOL_GEN = 2e-4


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy():
    """A biased 3x3 conv + relu + nearest x4 (receptive field 1 LR
    pixel), in both packages: the bias makes a zero halo visible."""
    rng = np.random.default_rng(3)
    kernel = rng.normal(0, 0.3, (3, 3, 3, 3)).astype(np.float32)
    bias = np.asarray([0.3, -0.1, 0.2], np.float32)
    k_oihw = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())

    def port(batch):
        y = F.conv2d(batch.permute(0, 3, 1, 2), k_oihw,
                     torch.from_numpy(bias), padding=1)
        return nearest_upsample(torch.relu(y.permute(0, 2, 3, 1)), 4)

    def ref(params, batch):
        dn = jax.lax.conv_dimension_numbers(batch.shape, kernel.shape,
                                            ("NHWC", "HWIO", "NHWC"))
        y = jax.lax.conv_general_dilated(batch, jnp.asarray(kernel), (1, 1),
                                         "SAME", dimension_numbers=dn)
        return jax_nearest(jax.nn.relu(y + bias), 4)

    return port, ref


def _mesh(ny, nx):
    return make_spatial_mesh([CPU] * (ny * nx), ny, nx)


@pytest.mark.parametrize("n,ny,nx", [(8, None, None), (8, 8, None),
                                     (6, None, 3), (1, None, None)])
def test_make_spatial_mesh_factors_like_jax(n, ny, nx):
    mesh = make_spatial_mesh([CPU] * n, ny, nx)
    if n == 8:
        want = jax_halo.make_spatial_mesh(ny, nx).devices.shape
        assert (mesh.ny, mesh.nx) == want
    assert mesh.ny * mesh.nx == n and len(mesh.devices) == n
    with pytest.raises(ValueError, match="devices"):
        make_spatial_mesh([CPU] * 6, 4, None)


def test_halo_toy_exact_and_equal_to_jax():
    port, ref = _toy()
    img = np.random.default_rng(0).random((64, 128, 3), np.float32)
    x = torch.from_numpy(img)
    mono = port(x[None])[0]
    for overlap in (2, 8):
        out = halo_upscale([port] * 8, x, _mesh(2, 4), scale=4,
                           overlap=overlap)
        assert out.shape == mono.shape == (256, 512, 3)
        np.testing.assert_allclose(out.numpy(), mono.numpy(), rtol=1e-5,
                                   atol=1e-5)
        want = jax_halo.halo_upscale(ref, None, jnp.asarray(img),
                                     jax_halo.make_spatial_mesh(2, 4),
                                     scale=4, overlap=overlap)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_halo_row_mesh_odd_size_matches_jax():
    """An 8 x 1 grid over a 51 x 37 image that pads: the padded far
    edge differs from the monolithic forward by the receptive field
    (as in JAX), and the whole result equals JAX's."""
    port, ref = _toy()
    img = np.random.default_rng(1).random((51, 37, 3), np.float32)
    x = torch.from_numpy(img)
    out = halo_upscale([port] * 8, x, _mesh(8, 1), scale=4, overlap=3)
    mono = port(x[None])[0]
    assert out.shape == (204, 148, 3)
    np.testing.assert_allclose(out[:-4, :-4].numpy(),
                               mono[:-4, :-4].numpy(), rtol=1e-5, atol=1e-5)
    want = jax_halo.halo_upscale(ref, None, jnp.asarray(img),
                                 jax_halo.make_spatial_mesh(8, 1), scale=4,
                                 overlap=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _generator(model, seed):
    jax_cls, port_cls, kw = {
        "srgan": (JaxSRGAN, SRGANGenerator, {"num_residual": 1}),
        "esrgan": (JaxESRGAN, ESRGANGenerator, {"num_rrdb_blocks": 1}),
    }[model]
    jg = jax_cls(**kw)
    variables = jax.tree.map(np.asarray, dict(jg.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)), train=False)))
    pg = port_cls(**kw, device="meta")
    pg.load_state_dict(from_jax_variables(variables), assign=True)
    pg = pg.eval().requires_grad_(False)

    def ref(v, batch):
        return jg.apply(v, batch, train=False)

    return pg, ref, variables


@pytest.mark.parametrize("model,overlap", [("srgan", 12), ("esrgan", 20)])
def test_halo_generator_exact_against_monolithic_and_jax(model, overlap):
    """A tiny generator whose receptive field the overlap covers (SRGAN,
    1 residual block: ~10 LR pixels; ESRGAN, 1 RRDB: ~18): the 2 x 4
    grid equals the monolithic forward and JAX's grid."""
    pg, ref, variables = _generator(model, 4)
    # blocks of at least 2 * overlap: no padding
    h, w = 4 * overlap, 8 * overlap
    img = np.random.default_rng(2).random((h, w, 3), np.float32)
    x = torch.from_numpy(img)
    with torch.no_grad():
        mono = pg(x[None])[0]
    out = halo_upscale([pg] * 8, x, _mesh(2, 4), scale=4, overlap=overlap)
    assert out.shape == mono.shape == (4 * h, 4 * w, 3)
    np.testing.assert_allclose(out.numpy(), mono.numpy(), rtol=ATOL_GEN,
                               atol=ATOL_GEN)
    want = jax_halo.halo_upscale(ref, variables, jnp.asarray(img),
                                 jax_halo.make_spatial_mesh(2, 4), scale=4,
                                 overlap=overlap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=ATOL_GEN, atol=ATOL_GEN)


def test_tiled_upscale_sharded_equals_tiled_and_jax():
    """Chunks spread over three devices: the same bytes as
    ``tiled_upscale``; against the JAX sharded path on its 8-device
    mesh (one tile a device a group) to 2e-5."""
    pg, ref, variables = _generator("srgan", 0)
    img = np.random.default_rng(0).random((70, 90, 3), np.float32)
    x = torch.from_numpy(img)
    single = tiled_upscale(pg, x, scale=4, tile=32, overlap=8, tile_batch=2)
    devices = [CPU] * 3
    forwards = sharded_forwards(pg, devices)
    assert all(f is not pg for f in forwards)
    sharded = tiled_upscale_sharded(forwards, x, devices, scale=4, tile=32,
                                    overlap=8, tile_batch=2)
    assert sharded.shape == single.shape == (280, 360, 3)
    assert torch.equal(sharded, single)
    mesh = make_mesh()
    want = jax_tiled_sharded(ref, replicate(variables, mesh),
                             jnp.asarray(img), mesh, scale=4, tile=32,
                             overlap=8, tile_batch_per_device=1)
    np.testing.assert_allclose(sharded.numpy(), np.asarray(want),
                               atol=2e-5)
    small = torch.from_numpy(img[:20, :24])
    assert torch.equal(
        tiled_upscale_sharded(forwards, small, devices, tile=32, overlap=8,
                              tile_batch=2),
        tiled_upscale(pg, small, tile=32, overlap=8, tile_batch=2))
    with pytest.raises(ValueError, match="one forward a device"):
        tiled_upscale_sharded(forwards[:2], x, devices)


def test_pair_conv_split_over_devices():
    """The batch split over a device list: the output and the
    gradients of x, the kernel and the bias equal the whole batch's."""
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((4, 6, 8, 64)).astype(np.float32)
    k0 = (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
    b0 = rng.standard_normal(64).astype(np.float32)
    outs = []
    for devices in (None, [CPU, CPU]):
        x, k, b = (torch.from_numpy(a).requires_grad_(True)
                   for a in (x0, k0, b0))
        y = pair_conv(x, k, b, devices=devices)
        y.square().sum().backward()
        outs.append([y.detach(), x.grad, k.grad, b.grad])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    gen = ESRGANGenerator(num_rrdb_blocks=1,
                          generator=torch.Generator().manual_seed(2))
    path = tmp_path_factory.mktemp("ck") / "g.pth"
    save_checkpoint(str(path), 1, "esrgan-gan", gen.state_dict())
    return str(path)


def test_test_subcommand_shards_on_the_cpu(checkpoint, tmp_path,
                                           monkeypatch):
    """``test --shard-tiles`` equals ``test --tile`` at the serving tile
    (one CPU device), and ``--spatial-shard`` (a 1 x 1 grid) the
    whole-image forward."""
    monkeypatch.chdir(tmp_path)
    img = np.random.default_rng(4).integers(0, 256, (40, 52, 3), np.uint8)
    Image.fromarray(img).save("a.png")
    base = ["test", "a.png", "--checkpoint", checkpoint, "--device", "cpu",
            "--tile-overlap", "4"]
    results = {}
    for name, extra in (("tiled", ["--tile", "16"]),
                        ("shard", ["--shard-tiles", "--tile", "16"]),
                        ("whole", []), ("spatial", ["--spatial-shard"])):
        cli.main(base + extra)
        results[name] = np.asarray(Image.open("upres-a.png"))
    assert results["shard"].shape == (160, 208, 3)
    np.testing.assert_array_equal(results["shard"], results["tiled"])
    np.testing.assert_array_equal(results["spatial"], results["whole"])


def test_service_shards_tiles_over_devices(checkpoint):
    """A checkpoint service with ``shard_devices`` answers the same bytes
    as one without."""
    img = np.random.default_rng(5).integers(0, 256, (30, 44, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    answers = []
    for shard in (None, [CPU, CPU]):
        svc = CheckpointUpscaleService(
            "esrgan", checkpoint=checkpoint, tile=16, tile_batch=2,
            device="cpu", shard_devices=shard)
        assert svc.meta["shard_devices"] == (len(shard) if shard else 0)
        answers.append(svc.upscale_bytes(buf.getvalue())[0])
    assert answers[0] == answers[1]
