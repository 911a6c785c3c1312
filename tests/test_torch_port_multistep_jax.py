"""The port's multi-step training programs against the JAX trainer's.

``pretrain_step_multi`` and ``gan_step_multi`` of the port's ESRGAN and
SRGAN trainers against the JAX trainers' multi-step programs
(``lax.scan``, the unrolled ESRGAN GAN chain) on the same weights and
batches, in f32 on the CPU, with the limits and the
``_assert_params_close`` of tests/test_torch_port_train_step.py.  The
port's K-step call equals its single steps bit for bit
(tests/test_torch_port_multistep.py).
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_port_multistep as tm
import test_torch_port_train_step as ts
from torchsr_tpu.data import synthetic as jax_synthetic
from torchsr_tpu.models.torch_compat import (
    convert_esrgan_generator,
    convert_srgan_generator,
)
from torchsr_tpu.parallel.mesh import (
    DistributedContext,
    make_mesh,
    put_stacked_batch,
    replicate,
)
from torchsr_tpu.train.trainer import ESRGANTrainer as JaxESRGAN
from torchsr_tpu.train.trainer import SRGANTrainer as JaxSRGAN
from torchsr_tpu_torch.models.torch_compat import from_jax_variables

CROP = ts.CROP
JAX_TRAINERS = {"esrgan": (JaxESRGAN, convert_esrgan_generator),
                "srgan": (JaxSRGAN, convert_srgan_generator)}


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Each step here is tiny: on one intra-op thread it runs as fast as
    on all of them, and the test workers that share the machine do not
    wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# The batch of the comparisons with the JAX programs (that of
# tests/test_step_parity.py).  At batch 2 the ESRGAN discriminator's
# last BatchNorms normalize 2 or 8 values, and the generator gradients
# through them at the second step, from one state on both sides, part
# from JAX's by a median 5.7% of their value (the losses by 1e-6), where
# the first step's part by 0.1%; at batch 4 both steps' part by 0.2%.
# The first Adam step follows the gradients' signs only, so
# tests/test_torch_port_train_step.py holds it at batch 2; a second
# step follows their sizes.
JAX_BATCH = 4


@pytest.fixture(scope="module", params=["esrgan", "srgan"])
def jax_pair(request):
    model = request.param
    jax_cls = JAX_TRAINERS[model][0]
    jt = jax_cls(
        ts._args(model=model, batch_size=JAX_BATCH),
        jax_synthetic.SyntheticTrainLoader(JAX_BATCH, CROP, n_batches=1),
        jax_synthetic.SyntheticEvalLoader(JAX_BATCH, CROP, n_batches=1), 1,
        1, make_mesh(num_devices=1), DistributedContext(1, -1, -1, 1, False))
    return model, jt, jax.device_get(jt.state)


def _port_from_jax(model, host, vgg_params):
    pt = tm._trainer(model, JAX_BATCH)
    variables = {"params": ts._np(host.gen_params)}
    if host.gen_stats:
        variables["batch_stats"] = ts._np(host.gen_stats)
    pt.gen.load_state_dict(from_jax_variables(variables))
    pt.disc.load_state_dict(from_jax_variables(
        {"params": ts._np(host.disc_params),
         "batch_stats": ts._np(host.disc_stats)}))
    pt.vgg.load_state_dict(from_jax_variables({"params": ts._np(vgg_params)}))
    return pt


def _load_jax_state(trainer, state, phase) -> None:
    """The JAX state's weights, BatchNorm statistics and the phase's
    generator Adam state (moments and count) into the port trainer, in
    place."""
    gen = {"params": ts._np(state.gen_params)}
    if state.gen_stats:
        gen["batch_stats"] = ts._np(state.gen_stats)
    trainer.gen.load_state_dict(from_jax_variables(gen))
    trainer.disc.load_state_dict(from_jax_variables(
        {"params": ts._np(state.disc_params),
         "batch_stats": ts._np(state.disc_stats)}))
    jax_opt = state.psnr_opt_state if phase == "pretrain" else \
        state.gen_opt_state
    adam = next(s for s in jax_opt if hasattr(s, "mu"))
    mu, nu = ({**gen, "params": ts._np(tree)} for tree in (adam.mu, adam.nu))
    mu, nu = from_jax_variables(mu), from_jax_variables(nu)
    opt = trainer.opt.psnr if phase == "pretrain" else trainer.opt.gen
    with torch.no_grad():
        for name, p in trainer.gen.named_parameters():
            st = opt.state[p]
            st["exp_avg"].copy_(mu[name])
            st["exp_avg_sq"].copy_(nu[name])
            st["step"].fill_(int(adam.count))


def _first_moments(module, opt, convert):
    """Adam's bias-corrected first moment of each parameter after the
    last step, in the JAX layout: the gradient the update followed (at
    the first step the gradient itself), which decides which elements
    ``_assert_params_close`` holds.  At a later step an element whose
    moment nearly cancels (0.9 of the last moment against 0.1 of a new
    gradient of the other sign) moves on a rounding-level difference,
    as a near-zero gradient does at the first."""
    saved = {p: p.grad for p in module.parameters()}
    for p in module.parameters():
        st = opt.state[p]
        p.grad = st["exp_avg"] / (1 - 0.9 ** float(st["step"]))
    try:
        return ts._grads(module, convert)
    finally:
        for p, g in saved.items():
            p.grad = g


@pytest.mark.parametrize("phase", ["pretrain", "gan"])
def test_multi_matches_jax_multi(jax_pair, phase):
    """The port's 2-step call against the JAX trainer's 2-step program
    on the same weights and batches (``JAX_BATCH``): both steps' losses at RTOL_LOSS (the
    discriminator's at RTOL_DISC_LOSS).  The parameters are held along
    the JAX program's path, step by step, with
    ``_assert_params_close`` (its decisive elements by the first moment,
    ``_first_moments``): the port's first step against the JAX
    program's first step alone, and the port's second step, started from
    the JAX weights after the first, against the JAX program's result.
    (Held end to end, the two paths part by more than one step's limits:
    an element the first step moved a full Adam step either way on a
    near-zero gradient changes the second step's gradients.)  The port's
    call equals its single steps bit for bit
    (tests/test_torch_port_multistep.py).  The GAN program
    runs with the discriminator's rate at 0, as
    tests/test_torch_port_train_step.py holds the generator's update."""
    model, jt, host = jax_pair
    crops, flips = tm._batches(2, seed=3, batch=JAX_BATCH)
    ct, ft = torch.from_numpy(crops), torch.from_numpy(flips)
    stacked = put_stacked_batch((crops, flips), jt.mesh)
    first = jt._put(crops[0], flips[0])
    pt = _port_from_jax(model, host, jt.vgg_params)
    if phase == "pretrain":
        state2, loss_j = jt.pretrain_step_multi(replicate(host, jt.mesh),
                                                *stacked)
        state1, _ = jt.pretrain_step(replicate(host, jt.mesh), *first)
        got, want = {"loss": pt.pretrain_step_multi(ct, ft)}, {"loss": loss_j}

        def step(trainer, i):
            trainer.pretrain_step(ct[i], ft[i])
    else:
        state2, want = jt.gan_step_multi(replicate(host, jt.mesh), *stacked,
                                         ts.LR, 0.0, jt.vgg_params)
        state1, _ = jt.gan_step(replicate(host, jt.mesh), *first, ts.LR,
                                0.0, jt.vgg_params)
        got = pt.gan_step_multi(ct, ft, ts.LR, 0.0)

        def step(trainer, i):
            trainer.gan_step(ct[i], ft[i], ts.LR, 0.0)
    for key in want:
        rtol = ts.RTOL_DISC_LOSS if key == "disc_loss" else ts.RTOL_LOSS
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=rtol, err_msg=key)
    assert pt.step == 2
    convert = JAX_TRAINERS[model][1]
    walker = _port_from_jax(model, host, jt.vgg_params)
    opt = walker.opt.psnr if phase == "pretrain" else walker.opt.gen
    for i, target in enumerate(map(jax.device_get, (state1, state2))):
        if i:
            _load_jax_state(walker, jax.device_get(state1), phase)
        step(walker, i)
        ts._assert_params_close(
            target.gen_params, convert(walker.gen.state_dict())["params"],
            _first_moments(walker.gen, opt, convert), ts.NOISE_GEN,
            f"{model} generator, step {i + 1}")
