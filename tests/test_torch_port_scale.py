"""``--scale 2`` and ``--scale 8`` against the JAX package.

The JAX generators at scale 2 and 8 are initialised from a fixed key,
their variables cross to the port through ``from_jax_variables`` (the
port sizes the generator from the keys: ``sized_to``), and both run the
same numpy input with ``train=False`` in f32 on the CPU (the port's
plain path, JAX's XLA one).  The port's pair and eval synthesis at
those ratios are held against the JAX ``make_train_preprocess`` and
``make_eval_preprocess``.  Then ``train --scale N --device cpu`` runs
end to end and ``test`` on what it wrote answers N x the input.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.data.preprocess import (
    make_eval_preprocess,
    make_train_preprocess,
)
from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxESRGAN
from torchsr_tpu.models.srgan import SRGANGenerator as JaxSRGAN
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.data.preprocess import (
    synthesize_eval_triple,
    synthesize_pair,
)
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.srgan import SRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.utils import doctor

# f32 through 2 blocks and the upsample stages in other summation
# orders (tests/test_torch_port_generator.py's limit at 4x)
ATOL = 1e-5
# The synthesis: HR bit for bit; LR on the same k/255 grid, one level
# apart at quantization ties only (tests/test_torch_port_train_data.py),
# and the eval triple's re-upscale of each side's own LR inherits such a
# level and may round one more.  Ties are commoner at 2x, whose
# antialiased taps are short fractions: measured over three seeds of
# (4, 64, 64, 3) crops, LR 0.09-0.24% of values at 2x, <= 0.13% at 4x
# and 8x; the re-upscale at 2x 0.16-0.22%, at most 2 levels.
ATOL_SYNTH = 1e-6
TIE_FRACTION = 5e-3

MODELS = {"esrgan": (JaxESRGAN, ESRGANGenerator, "num_rrdb_blocks"),
          "srgan": (JaxSRGAN, SRGANGenerator, "num_residual")}


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("scale", [2, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_generator_at_scale_matches_jax(model, scale):
    jax_cls, port_cls, blocks = MODELS[model]
    gen = jax_cls(scale_factor=scale, **{blocks: 2})
    x = np.random.default_rng(scale).random((2, 6, 7, 3), dtype=np.float32)
    variables = gen.init(jax.random.PRNGKey(scale), jnp.asarray(x),
                         train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    want = np.asarray(gen.apply(variables, jnp.asarray(x), train=False))
    state = from_jax_variables(variables)
    ours = port_cls.sized_to(state, device="meta")
    ours.load_state_dict(state, assign=True)
    ours = ours.eval().requires_grad_(False)
    assert ours.scale_factor == scale
    with torch.inference_mode():
        got = ours(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _close(got, want, levels=1):
    diff = np.abs(got - np.asarray(want))
    assert float(diff.max()) <= levels / 255 + ATOL_SYNTH, float(diff.max())
    assert float((diff > 0).mean()) <= TIE_FRACTION


@pytest.mark.parametrize("scale", [2, 8])
def test_synthesis_at_scale_matches_jax(scale):
    rng = np.random.default_rng(scale)
    crops = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    flips = rng.integers(0, 2, (4, 2)).astype(bool)
    lr_j, hr_j = make_train_preprocess(scale)(crops, flips)
    lr, hr = synthesize_pair(torch.from_numpy(crops),
                             torch.from_numpy(flips), scale)
    assert lr.shape == (4, 64 // scale, 64 // scale, 3)
    np.testing.assert_array_equal(hr.numpy(), np.asarray(hr_j))
    _close(lr.numpy(), lr_j)
    want = make_eval_preprocess(scale)(crops)
    got = synthesize_eval_triple(torch.from_numpy(crops), scale)
    for g, w, levels in zip(got, want, (1, 2, 0)):
        assert g.shape == w.shape
        _close(g.numpy(), w, levels)


@pytest.mark.parametrize("scale", [2, 8])
def test_train_then_test_at_scale_on_cpu(scale, image_dir, tmp_path,
                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (6, 10, 3), np.uint8)).save("sample.png")
    cli.main(["train", "--device", "cpu", "--train-dir", image_dir,
              "--gen-blocks", "1", "--vgg-convs", "2", "--crop-size", "32",
              "--batch-size", "4", "--epochs", "1", "--pretrain-epochs", "1",
              "--scale", str(scale), "--sample-image", "sample.png"])
    with Image.open(os.path.join("output", "SR_epoch1.png")) as img:
        assert img.size == (10 * scale, 6 * scale)
    cli.main(["test", "sample.png", "--checkpoint", "esrgan-gan-best.pth",
              "--device", "cpu"])
    with Image.open("upres-sample.png") as img:
        assert img.size == (10 * scale, 6 * scale)
    info = doctor.collect_report(checkpoint="esrgan-gan-best.pth",
                                 device_check=False)["checkpoint"]
    assert info["detected_scale"] == scale
    with pytest.raises(SystemExit):  # the LR crop must be whole
        cli.parse_args(["train", "--scale", str(scale), "--crop-size",
                        str(8 * scale + 1)])
