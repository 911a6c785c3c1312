"""One pretrain step and one GAN step of the port against the JAX trainer.

The JAX ``ESRGANTrainer`` is built at a small size (``--gen-blocks 1``,
crop 32, batch 2, ``--vgg-convs 2``, f32); its initial generator,
discriminator (with BatchNorm statistics) and VGG weights cross to the
port's trainer through ``from_jax_variables``; both take one
``pretrain_step`` and one ``gan_step`` on the same uint8 batch, the
method of tests/test_step_parity.py, and one ``gan_step`` at ``--scale
2`` and ``--scale 8``.  Then the port's ``train`` runs on
the CPU end to end and ``test`` loads what it wrote.

Adam's first step moves each parameter by about lr * sign(g), so an
element whose gradient is near zero, or whose sign a rounding-level
difference upstream decides, moves a full step the other way in the
other framework.  Every element with a decisive gradient must match to
the stated tolerance; the others are bounded by two opposite steps and
may be at most 10% of a tensor (``_assert_params_close``).
"""

import os
import types
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.data.preprocess import synthesize_pair as jax_pair
from torchsr_tpu.data.synthetic import (
    SyntheticEvalLoader,
    SyntheticTrainLoader,
)
from torchsr_tpu.models.torch_compat import (
    convert_esrgan_discriminator,
    convert_esrgan_generator,
)
from torchsr_tpu.parallel.mesh import DistributedContext, make_mesh, replicate
from torchsr_tpu.train.trainer import ESRGANTrainer as JaxTrainer
from torchsr_tpu.train.trainer import _match_tree
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.data.preprocess import synthesize_pair
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.ops import rdb as rdb_ops
from torchsr_tpu_torch.train.trainer import ESRGANTrainer
from torchsr_tpu_torch.utils.checkpoint import load_checkpoint
from torchsr_tpu_torch.utils.logging import Logger

BATCH, CROP, LR = 2, 32, 1e-4
# losses: f32 sums in other orders (measured <= 1e-5)
RTOL_LOSS = 5e-5
# the discriminator's loss: at crop 32 its last four BatchNorms see a
# 2 x 2 or 1 x 1 map, so at batch 2 they normalize over 8 or 2 values,
# where rounding-level input differences move the output most, and the
# two frameworks compute the moments differently (JAX: one pass shifted
# by the running mean; torch: two passes); measured 7.7e-5
RTOL_DISC_LOSS = 3e-4
# decisive elements: one Adam step of lr moves them, f32 noise on top
ATOL_PARAM, RTOL_PARAM = 2e-5, 1e-3
# a gradient is decisive above this fraction of its tensor's largest.
# Measured flipped elements: the generator update with the
# discriminator's lr at 0 <= 2.6% of the tensor's max; the
# discriminator update <= 3.3% (its last BatchNorm normalizes over 2
# values at batch 2, crop 32; tests/test_step_parity.py, at batch 4,
# uses 1%)
NOISE_GEN, NOISE_DISC = 0.05, 0.05
# the --scale 2/8 steps run at batch 4, as tests/test_step_parity.py
# does: at batch 2 the discriminator's update is at the mercy of
# rounding (one f32 ulp on the port's own LR input flips elements with
# |g| up to 66% of a tensor's max at 4x); at batch 4 the flipped
# elements measured <= 0.05% (2x) and 0.13% (8x) of the max
SCALE_BATCH = 4
# the discriminator's running statistics after four train-mode calls
# through a discriminator whose near-zero-gradient weights moved +-lr
# apart (measured 6.3e-4; tests/test_step_parity.py allows 5e-3)
ATOL_STATS, RTOL_STATS = 5e-3, 1e-3


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    base = dict(batch_size=BATCH, disable_amp=True, epochs=1,
                pretrain_epochs=1, gan_checkpoint=None, psnr_checkpoint=None,
                seed=0, skip_image_save=True, model="esrgan", num_residual=1,
                vgg_convs=2, metrics_file=None, vgg_weights=None)
    base.update(kw)
    return Namespace(**base)


@pytest.fixture(scope="module")
def jax_trainer():
    trainer = JaxTrainer(
        _args(), SyntheticTrainLoader(BATCH, CROP, n_batches=1),
        SyntheticEvalLoader(BATCH, CROP, n_batches=1), 1, 1,
        make_mesh(num_devices=1), DistributedContext(1, -1, -1, 1, False))
    return trainer, jax.device_get(trainer.state)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _port_trainer(host, vgg_params, **kw):
    """A port trainer holding the JAX state ``host``."""
    trainer = ESRGANTrainer(_args(**kw),
                            types.SimpleNamespace(crop_size=CROP),
                            None, 1, 1, device=torch.device("cpu"),
                            logger=Logger())
    trainer.gen.load_state_dict(from_jax_variables(
        {"params": _np(host.gen_params)}))
    trainer.disc.load_state_dict(from_jax_variables(
        {"params": _np(host.disc_params),
         "batch_stats": _np(host.disc_stats)}))
    trainer.vgg.load_state_dict(from_jax_variables(
        {"params": _np(vgg_params)}))
    return trainer


def _batch(n=BATCH):
    rng = np.random.default_rng(42)
    crops = rng.integers(0, 256, (n, CROP, CROP, 3), dtype=np.uint8)
    flips = np.array([[True, False], [False, True], [True, True],
                      [False, False]][:n])
    # the same LR/HR pair on both sides (no quantization tie in it)
    lr_j, hr_j = jax_pair(crops, flips, 4)
    lr, hr = synthesize_pair(torch.from_numpy(crops),
                             torch.from_numpy(flips), 4)
    np.testing.assert_allclose(lr.numpy(), np.asarray(lr_j), atol=1e-6)
    np.testing.assert_allclose(hr.numpy(), np.asarray(hr_j), atol=1e-6)
    return crops, flips


def _grads(module, convert):
    """The parameters' gradients in the JAX layout (the buffers ride
    along as values so that the converter applies)."""
    sd = dict(module.state_dict())
    for k, p in module.named_parameters():
        sd[k] = p.grad if p.grad is not None else torch.zeros_like(p)
    return convert(sd)["params"]


def _assert_params_close(ours_jax, port_tree, grads, noise_frac, what):
    """JAX's updated parameters against the port's (in the JAX layout),
    with ``grads`` the port's gradients: decisive elements to
    (ATOL_PARAM, RTOL_PARAM), the others within two Adam steps and at
    most 10% (or 4 elements) of a tensor."""
    theirs = _match_tree(ours_jax, port_tree)
    grads = _match_tree(ours_jax, grads)
    _assert_leaves_close(
        ((f"{what} {jax.tree_util.keystr(path)}", a, b, g)
         for (path, a), b, g in zip(
             jax.tree_util.tree_flatten_with_path(ours_jax)[0],
             jax.tree.leaves(theirs), jax.tree.leaves(grads))),
        noise_frac)


def _assert_state_close(jax_tree, module, noise_frac, what):
    """The same rule in the port's layout: JAX's updated parameters
    through ``from_jax_variables`` against ``module``'s, with its
    gradients (the JAX package's converters to its layout know only
    the 4x generator)."""
    want = from_jax_variables({"params": _np(jax_tree)})
    _assert_leaves_close(
        ((f"{what} {name}", want[name], p.detach(),
          p.grad if p.grad is not None else torch.zeros_like(p))
         for name, p in module.named_parameters()),
        noise_frac)


def _assert_leaves_close(leaves, noise_frac):
    """(where, JAX's, the port's, the port's gradient) a leaf: decisive
    elements to (ATOL_PARAM, RTOL_PARAM), the others within two Adam
    steps and at most 10% (or 4 elements) of a tensor."""
    for where, a, b, g in leaves:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        g = np.abs(np.asarray(g, np.float64))
        assert a.shape == b.shape, where
        bad = np.abs(a - b) > ATOL_PARAM + RTOL_PARAM * np.abs(b)
        decisive = g >= max(1e-7, noise_frac * float(g.max()))
        assert not (bad & decisive).any(), (
            f"{where}: {int((bad & decisive).sum())}/{a.size} elements "
            f"with decisive gradients beyond tolerance, |g| / max|g| "
            f"{float(g[bad & decisive].max() / g.max()):.3g}")
        assert float(np.abs(a - b).max()) <= 2.1 * LR, where
        assert float(bad.mean()) < 0.10 or int(bad.sum()) <= 4, (
            f"{where}: {int(bad.sum())}/{a.size} flips")


def test_pretrain_step_matches_jax(jax_trainer):
    jt, host = jax_trainer
    crops, flips = _batch()
    pt = _port_trainer(host, jt.vgg_params)
    state, loss_j = jt.pretrain_step(replicate(host, jt.mesh),
                                     *jt._put(crops, flips))
    loss = pt.pretrain_step(torch.from_numpy(crops), torch.from_numpy(flips))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=RTOL_LOSS)
    _assert_params_close(
        jax.device_get(state.gen_params),
        convert_esrgan_generator(pt.gen.state_dict())["params"],
        _grads(pt.gen, convert_esrgan_generator), NOISE_GEN, "generator")
    assert pt.step == 1


@pytest.mark.parametrize("disc_lr", [0.0, LR], ids=["disc_lr0", "disc_lr"])
def test_gan_step_matches_jax(jax_trainer, disc_lr):
    """disc_lr 0 holds the generator's update (the discriminator the
    generator loss sees is the same on both sides); disc_lr = lr holds
    the discriminator's update and its BatchNorm statistics."""
    jt, host = jax_trainer
    crops, flips = _batch()
    pt = _port_trainer(host, jt.vgg_params)
    state, met = jt.gan_step(replicate(host, jt.mesh),
                             *jt._put(crops, flips), LR, disc_lr,
                             jt.vgg_params)
    got = pt.gan_step(torch.from_numpy(crops), torch.from_numpy(flips),
                      LR, disc_lr)
    for key, rtol in (("disc_loss", RTOL_DISC_LOSS), ("gen_loss", RTOL_LOSS)):
        assert torch.isfinite(got[key])
        np.testing.assert_allclose(float(got[key]), float(met[key]),
                                   rtol=rtol, err_msg=key)
    state = jax.device_get(state)
    disc = convert_esrgan_discriminator(pt.disc.state_dict(),
                                        image_size=CROP)
    if disc_lr == 0.0:
        _assert_params_close(
            state.gen_params,
            convert_esrgan_generator(pt.gen.state_dict())["params"],
            _grads(pt.gen, convert_esrgan_generator), NOISE_GEN,
            "generator")
    else:
        _assert_params_close(
            state.disc_params, disc["params"],
            _grads(pt.disc, lambda sd: convert_esrgan_discriminator(
                sd, image_size=CROP)), NOISE_DISC, "discriminator")
    stats = _match_tree(state.disc_stats, disc["batch_stats"])
    for a, b in zip(jax.tree.leaves(state.disc_stats),
                    jax.tree.leaves(stats)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=ATOL_STATS, rtol=RTOL_STATS)


@pytest.fixture(scope="module", params=[2, 8], ids=["x2", "x8"])
def jax_trainer_at_scale(request):
    scale = request.param
    trainer = JaxTrainer(
        _args(upscale_factor=scale, batch_size=SCALE_BATCH),
        SyntheticTrainLoader(SCALE_BATCH, CROP, n_batches=1),
        SyntheticEvalLoader(SCALE_BATCH, CROP, n_batches=1), 1, 1,
        make_mesh(num_devices=1), DistributedContext(1, -1, -1, 1, False))
    return scale, trainer, jax.device_get(trainer.state)


@pytest.mark.parametrize("disc_lr", [0.0, LR], ids=["disc_lr0", "disc_lr"])
def test_gan_step_at_scale_matches_jax(jax_trainer_at_scale, disc_lr,
                                       monkeypatch):
    """``--scale 2`` and ``--scale 8``: one GAN step on the LR/HR pair
    JAX synthesizes (at 2x the two syntheses differ by one uint8 level
    at ties, held with their own tolerance in
    tests/test_torch_port_scale.py, so here the port's step is handed
    JAX's pair), at batch 4, to the 4x test's tolerances."""
    from torchsr_tpu_torch.train import trainer as trainer_mod

    scale, jt, host = jax_trainer_at_scale
    crops, flips = _batch(SCALE_BATCH)
    lr_j, hr_j = jax_pair(crops, flips, scale)
    monkeypatch.setattr(
        trainer_mod, "synthesize_pair",
        lambda c, f, s: (torch.from_numpy(np.array(lr_j)),
                         torch.from_numpy(np.array(hr_j))))
    pt = _port_trainer(host, jt.vgg_params, upscale_factor=scale,
                       batch_size=SCALE_BATCH)
    assert pt.upscale == scale and pt.gen.scale_factor == scale
    state, met = jt.gan_step(replicate(host, jt.mesh),
                             *jt._put(crops, flips), LR, disc_lr,
                             jt.vgg_params)
    got = pt.gan_step(torch.from_numpy(crops), torch.from_numpy(flips),
                      LR, disc_lr)
    for key, rtol in (("disc_loss", RTOL_DISC_LOSS), ("gen_loss", RTOL_LOSS)):
        assert torch.isfinite(got[key])
        np.testing.assert_allclose(float(got[key]), float(met[key]),
                                   rtol=rtol, err_msg=key)
    state = jax.device_get(state)
    if disc_lr == 0.0:
        _assert_state_close(state.gen_params, pt.gen, NOISE_GEN,
                            "generator")
    else:
        _assert_params_close(
            state.disc_params,
            convert_esrgan_discriminator(pt.disc.state_dict(),
                                         image_size=CROP)["params"],
            _grads(pt.disc, lambda sd: convert_esrgan_discriminator(
                sd, image_size=CROP)), NOISE_DISC, "discriminator")


def test_gan_step_keeps_the_discriminator_trainable(jax_trainer):
    """The generator loss runs with the discriminator frozen; the step
    leaves it trainable, with its gradients from its own loss only."""
    jt, host = jax_trainer
    crops, flips = _batch()
    pt = _port_trainer(host, jt.vgg_params)
    pt.gan_step(torch.from_numpy(crops), torch.from_numpy(flips), LR, LR)
    assert all(p.requires_grad for p in pt.disc.parameters())
    assert all(p.grad is not None for p in pt.disc.parameters())
    assert not any(p.requires_grad for p in pt.vgg.parameters())
    assert pt.step == 1


def test_train_then_test_on_the_cpu(tmp_path, monkeypatch):
    """``train --device cpu`` end to end (both phases, evals, the
    sample render, four checkpoints, the metrics file); a rerun resumes
    each phase from its -latest checkpoint with its training state (the
    saved epoch runs again, as in the reference); then ``test --device
    cpu`` on gan-best."""
    rng = np.random.default_rng(7)
    (tmp_path / "ds").mkdir()
    (tmp_path / "media").mkdir()
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (40, 44, 3), np.uint8)).save(
            tmp_path / "ds" / f"img{i}.png")
    Image.fromarray(rng.integers(0, 256, (8, 12, 3), np.uint8)).save(
        tmp_path / "media" / "waterfalls-low-res.png")
    monkeypatch.chdir(tmp_path)
    before = (rdb_ops.RDB_FWD_LAUNCHES, rdb_ops.RDB_BWD_LAUNCHES)
    argv = ["train", "--device", "cpu", "--train-dir", "ds",
            "--gen-blocks", "1", "--vgg-convs", "2", "--crop-size", "32",
            "--batch-size", "3", "--epochs", "1", "--pretrain-epochs", "1",
            "--metrics-file", "m.jsonl"]
    cli.main(argv)
    assert (rdb_ops.RDB_FWD_LAUNCHES, rdb_ops.RDB_BWD_LAUNCHES) == before
    for phase in ("psnr", "gan"):
        for kind in ("best", "latest"):
            assert os.path.exists(f"esrgan-{phase}-{kind}.pth")
    best = load_checkpoint("esrgan-gan-best.pth")
    assert best["phase"] == "esrgan-gan" and best["epoch"] == 1
    # 9 train images (one held out), batch 3: 3 steps per phase
    assert best["extra"]["step"] == 6
    assert set(best["extra"]) >= {"disc_state", "psnr_opt_state",
                                  "gen_opt_state", "disc_opt_state",
                                  "best_psnr"}
    assert os.path.exists(os.path.join("output", "SR_epoch1.png"))
    import json

    rows = [json.loads(ln) for ln in open("m.jsonl")]
    keys = {k for r in rows for k in r}
    assert {"psnr/train-loss", "psnr/PSNR", "psnr/SSIM", "gan/train-loss",
            "gan/gen-lr", "gan/PSNR", "gan/val-loss"} <= keys
    losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
    assert losses and all(np.isfinite(losses))
    # psnr-latest restores step 3, gan-latest step 6: 3 + 3 more
    cli.main(argv)
    assert load_checkpoint("esrgan-gan-latest.pth")["extra"]["step"] == 9
    cli.main(["test", os.path.join("ds", "img0.png"), "--device", "cpu",
              "--checkpoint", "esrgan-gan-best.pth"])
    with Image.open("upres-img0.png") as img:
        assert img.size == (44 * 4, 40 * 4)


def test_train_refuses_a_missing_card_and_srgan(monkeypatch):
    """Without a card ``train`` refuses, for either model; SRGAN is no
    longer refused on the CPU: the registry gives its trainer at crop 96,
    which builds the full-width networks."""
    from torchsr_tpu_torch.registry import select_trainer_model
    from torchsr_tpu_torch.train.trainer import SRGANTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("esrgan", "srgan"):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["train", "--train-dir", "missing", "--model", model])
    trainer_cls, crop = select_trainer_model(Namespace(model="SRGAN"))
    assert (trainer_cls, crop) == (SRGANTrainer, 96)
    trainer = trainer_cls(_args(model="srgan", num_residual=None),
                          types.SimpleNamespace(crop_size=crop), None, 1, 1,
                          device=torch.device("cpu"), logger=Logger())
    assert sum(p.numel() for p in trainer.gen.parameters()) == 1_547_350
    assert trainer.disc.classifier[0].weight.shape == (1024, 512 * 6 * 6)
