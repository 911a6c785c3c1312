"""The GAN phase against JAX's, epoch by epoch, at the recipe's structure.

``tests/test_torch_port_gan_epochs.py`` at ESRGAN's crop of the quality
recipe (128, LR 32 x 32) with the whole VGG19 trunk (16 convs through
relu5_4, no ``--vgg-convs``), the perceptual loss's structure in the
round-5 runs, held to that file's rules: each step's learning rates and
batch, the eval PSNR and the ``-best`` epochs, the re-synced epochs
within the per-step limits from epoch 2, and epoch 1 within its
rounding witness.  Both trainers run the GAN phase in f32 on the CPU;
the generator keeps one RRDB and the batch 4, as there.

It is slow (minutes: the full trunk at 128 x 128, forward on the
crops and backward through the generator's, each step, on both sides),
so it is marked ``slow`` and left out of the tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow \\
        tests/test_torch_port_gan_epochs_recipe.py -q
"""

import pytest
import torch

import test_torch_port_gan_epochs as ge

pytestmark = pytest.mark.slow

RECIPE_CROP = 128


# one torch thread for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ge.all_runs("esrgan", tmp_path_factory.mktemp("recipe"),
                       crop=RECIPE_CROP, vgg_convs=None)


def test_vgg_is_the_whole_trunk(runs):
    _, jax_run, *_ = runs
    convs = [k for k in jax_run["vgg"] if "conv" in k.lower()]
    assert len(convs) == 16, sorted(jax_run["vgg"])


def test_learning_rates_and_data_order_per_step(runs):
    ge.test_learning_rates_and_data_order_per_step(runs)


def test_eval_psnr_and_best_epochs(runs):
    ge.test_eval_psnr_and_best_epochs(runs)


def test_resynced_epochs_match_jax_parameters(runs):
    ge.test_resynced_epochs_match_jax_parameters(runs)


def test_first_epoch_within_its_rounding_witness(runs):
    ge.test_first_epoch_within_its_rounding_witness(runs)


def test_free_run_gap_per_epoch(runs, capsys):
    ge.test_free_run_gap_per_epoch(runs, capsys)
