"""The port's network interpolation against the JAX package's, on the CPU.

The same two generators (seeded JAX inits; SRGAN's BatchNorm
statistics moved apart) are blended by the JAX ``interpolate_states``
and the port's at alpha 0, 0.2 and 1, for ESRGAN and SRGAN.  Both blend
in f32, so the results are equal; alpha 0 and 1 return the inputs bit
for bit, the integer ``num_batches_tracked`` included.  A mismatch of
architecture or shape raises; the ``interp`` subcommand reads ``.ckpt``
and ``.pth`` inputs and writes a checkpoint that ``test`` and ``eval``
load.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.models import ESRGANGenerator as JaxESRGAN
from torchsr_tpu.models import SRGANGenerator as JaxSRGAN
from torchsr_tpu.utils.checkpoint import save_checkpoint as jax_save
from torchsr_tpu.utils.interp import interpolate_states as jax_interp
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from torchsr_tpu_torch.utils.interp import interpolate_states

MODELS = {"esrgan": lambda n: JaxESRGAN(num_rrdb_blocks=n),
          "srgan": lambda n: JaxSRGAN(num_residual=n)}


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(model, seed, blocks=1):
    variables = jax.tree.map(np.asarray, dict(MODELS[model](blocks).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)), train=False)))
    if "batch_stats" in variables:
        rng = np.random.default_rng(seed)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(a.dtype),
            variables["batch_stats"])
    return variables


def _counts(state, psnr, gan):
    """Give the two inputs' BatchNorms different step counts."""
    for key in state:
        if key.endswith("num_batches_tracked"):
            psnr[key], gan[key] = torch.tensor(7), torch.tensor(12)


@pytest.mark.parametrize("alpha", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("model", ["esrgan", "srgan"])
def test_blend_matches_jax(model, alpha):
    psnr_vars, gan_vars = _variables(model, 1), _variables(model, 2)
    psnr = from_jax_variables(psnr_vars)
    gan = from_jax_variables(gan_vars)
    _counts(psnr, psnr, gan)
    got = interpolate_states(psnr, gan, alpha)
    want = from_jax_variables(jax_interp(psnr_vars, gan_vars, alpha))
    assert list(got) == list(want)
    for key, value in got.items():
        assert value.dtype == psnr[key].dtype, key
        if key.endswith("num_batches_tracked"):
            # no JAX leaf: blended and rounded
            assert int(value) == round((1 - alpha) * 7 + alpha * 12), key
        else:
            assert torch.equal(value, want[key]), key
    if alpha in (0.0, 1.0):
        end = psnr if alpha == 0.0 else gan
        for key, value in got.items():
            assert torch.equal(value, end[key]), key


def test_mismatches_raise():
    one = from_jax_variables(_variables("esrgan", 1, blocks=1))
    two = from_jax_variables(_variables("esrgan", 2, blocks=2))
    with pytest.raises(ValueError, match="architecture"):
        interpolate_states(one, two, 0.5)
    with pytest.raises(ValueError, match="architecture"):
        interpolate_states(one, from_jax_variables(_variables("srgan", 1)),
                           0.5)
    wide = dict(one)
    wide["conv1.bias"] = torch.zeros(65)
    with pytest.raises(ValueError, match="shape mismatch"):
        interpolate_states(one, wide, 0.5)


@pytest.mark.parametrize("model", ["esrgan", "srgan"])
def test_interp_cli_output_loads_in_test_and_eval(model, tmp_path,
                                                  monkeypatch):
    """A JAX ``.ckpt`` and a port ``.pth`` in, a ``.pth`` out; ``test``
    and ``eval`` load it."""
    monkeypatch.chdir(tmp_path)
    jax_save("psnr.ckpt", 3, f"{model}-psnr", _variables(model, 1))
    save_checkpoint("gan.pth", 5, f"{model}-gan",
                    from_jax_variables(_variables(model, 2)))
    cli.main(["interp", "psnr.ckpt", "gan.pth", "--alpha", "0.2",
              "--model", model])
    out = f"{model}-interp-0.2.pth"
    ckpt = load_checkpoint(out, model)
    assert (ckpt["epoch"], ckpt["phase"]) == (5, "interp")
    want = interpolate_states(load_checkpoint("psnr.ckpt")["state"],
                              load_checkpoint("gan.pth")["state"], 0.2)
    for key, value in want.items():
        assert torch.equal(ckpt["state"][key], value), key
    os.makedirs("val")
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (24, 28, 3), np.uint8)).save(
        "val/a.png")
    cli.main(["test", "val/a.png", "--model", model, "--checkpoint", out,
              "--device", "cpu"])
    with Image.open("upres-a.png") as img:
        assert img.size == (28 * 4, 24 * 4)
    cli.main(["eval", "val", "--model", model, "--checkpoint", out,
              "--device", "cpu", "--report", "r.json"])
    assert os.path.exists("r.json")
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        cli.main(["interp", "psnr.ckpt", "missing.pth", "--model", model])
