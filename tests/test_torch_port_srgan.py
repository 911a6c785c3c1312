"""The port's SRGAN family against the JAX package's, on the CPU.

The pixel shuffle on an asymmetric channel pattern; the generator (2
residual blocks, the JAX fused head) and the discriminator (crop 32) in
train and eval mode, BatchNorm running statistics included; weights
both ways through the JAX package's converters and a JAX ``.ckpt``;
one pretrain step and one GAN step of ``SRGANTrainer`` against the JAX
trainer (the method and limits of tests/test_torch_port_train_step.py,
the generator's BatchNorm statistics added); then ``train`` -> ``test``
-> ``serve`` with ``--model srgan --device cpu``.  Inputs come from
numpy with a seed; everything runs in f32.
"""

import io
import os
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_port_train_step as ts
from torchsr_tpu.data.synthetic import (
    SyntheticEvalLoader,
    SyntheticTrainLoader,
)
from torchsr_tpu.models.srgan import SRGANDiscriminator as JaxDisc
from torchsr_tpu.models.srgan import SRGANGenerator as JaxGen
from torchsr_tpu.models.torch_compat import (
    convert_srgan_discriminator,
    convert_srgan_generator,
    export_srgan_generator,
)
from torchsr_tpu.ops.pixel_shuffle import depth_to_space as jax_d2s
from torchsr_tpu.parallel.mesh import DistributedContext, make_mesh, replicate
from torchsr_tpu.train.trainer import SRGANTrainer as JaxTrainer
from torchsr_tpu.train.trainer import _match_tree
from torchsr_tpu.utils.checkpoint import save_checkpoint as jax_save
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.infer import server
from torchsr_tpu_torch.infer.tiled import tiled_upscale
from torchsr_tpu_torch.models.srgan import SRGANDiscriminator, SRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.ops import rdb as rdb_ops
from torchsr_tpu_torch.ops.pixel_shuffle import depth_to_space, space_to_depth
from torchsr_tpu_torch.train.trainer import SRGANTrainer
from torchsr_tpu_torch.utils.checkpoint import load_checkpoint
from torchsr_tpu_torch.utils.logging import Logger

BLOCKS, CROP, DISC_BATCH = 2, 32, 4
# f32 through 2 residual blocks, 9x9 convs and the JAX fused head (a
# relayout of the same sums); measured 1.2e-6 at outputs up to 0.48
ATOL_FWD = 2e-5
# BatchNorm statistics: torch's two-pass moments against JAX's one pass
# shifted by the running mean; measured 2.4e-7
ATOL_STATS_FWD = 1e-5
# the discriminator's probabilities: the sigmoid of logits that agree to
# f32 rounding; measured 6e-7
ATOL_PROB = 1e-5


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _perturb(variables, seed):
    """BatchNorm scales, biases and statistics and PReLU slopes away from
    their init, so that eval mode and the slopes' role are visible."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name or ("bn" in name and "'bias'" in name):
            return rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if "'var'" in name or ("bn" in name and "'scale'" in name):
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if "'alpha'" in name:
            return rng.uniform(0.05, 0.4, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, _np(variables))


@pytest.fixture(scope="module")
def gen_pair():
    jg = JaxGen(num_residual=BLOCKS)
    variables = _perturb(dict(jg.init(jax.random.PRNGKey(3),
                                      jnp.zeros((1, 8, 8, 3)),
                                      train=False)), 3)
    pg = SRGANGenerator(num_residual=BLOCKS, device="meta")
    pg.load_state_dict(from_jax_variables(variables), assign=True)
    return jg, variables, pg.requires_grad_(False)


@pytest.fixture(scope="module")
def disc_pair():
    jd = JaxDisc(image_size=CROP)
    variables = _perturb(dict(jd.init(jax.random.PRNGKey(5),
                                      jnp.zeros((1, CROP, CROP, 3)),
                                      train=False)), 5)
    pd = SRGANDiscriminator(image_size=CROP, device="meta")
    pd.load_state_dict(from_jax_variables(variables), assign=True)
    return jd, variables, pd.requires_grad_(False)


def _image(shape, seed):
    return np.random.default_rng(seed).random(shape, np.float32)


def _stats_close(jax_stats, port_sd, convert):
    ours = _match_tree(jax_stats, convert(port_sd)["batch_stats"])
    for a, b in zip(jax.tree.leaves(jax_stats), jax.tree.leaves(ours)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=ATOL_STATS_FWD, rtol=1e-5)


def test_generator_has_the_jax_parameter_count():
    gen = SRGANGenerator(device="meta")
    assert sum(p.numel() for p in gen.parameters()) == 1_547_350


def test_depth_to_space_is_jax_order():
    """Channel c * 4 + i * 2 + j -> channel c at offset (i, j): a
    pattern with every channel distinct tells (c, i, j) from (i, j, c)."""
    x = (np.arange(2 * 3 * 5 * 12, dtype=np.float32).reshape(2, 3, 5, 12)
         + np.random.default_rng(1).random((2, 3, 5, 12), np.float32))
    got = depth_to_space(torch.from_numpy(x), 2)
    want = np.asarray(jax_d2s(jnp.asarray(x), 2))
    assert got.shape == (2, 6, 10, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(space_to_depth(got, 2), torch.from_numpy(x))
    with pytest.raises(ValueError, match="divisible"):
        depth_to_space(torch.zeros((1, 2, 2, 6)), 2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_generator_forward_matches_jax(gen_pair, train):
    jg, variables, pg = gen_pair
    x = _image((2, 10, 12, 3), 11)
    pg.train(train)
    try:
        if train:
            want, mut = jg.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        else:
            want = jg.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            before = {k: v.clone() for k, v in pg.state_dict().items()}
            got = pg(torch.from_numpy(x))
        assert got.shape == (2, 40, 48, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_FWD, rtol=0)
        if train:
            _stats_close(_np(mut["batch_stats"]), pg.state_dict(),
                         convert_srgan_generator)
        else:  # eval mode leaves the running statistics as they were
            for k, v in pg.state_dict().items():
                assert torch.equal(v, before[k]), k
    finally:
        pg.load_state_dict(from_jax_variables(variables))
        pg.eval()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_forward_matches_jax(disc_pair, train):
    jd, variables, pd = disc_pair
    x = _image((DISC_BATCH, CROP, CROP, 3), 12)
    pd.train(train)
    try:
        out = jd.apply(variables, jnp.asarray(x), train=train,
                       mutable=["batch_stats"])
        with torch.no_grad():
            got = pd(torch.from_numpy(x))
        assert got.shape == (DISC_BATCH, 1) and got.dtype == torch.float32
        assert float(got.min()) > 0 and float(got.max()) < 1
        np.testing.assert_allclose(got.numpy(), np.asarray(out[0]),
                                   atol=ATOL_PROB, rtol=0)
        _stats_close(_np(out[1]["batch_stats"]), pd.state_dict(),
                     lambda sd: convert_srgan_discriminator(sd, CROP))
    finally:
        pd.load_state_dict(from_jax_variables(variables))


def test_weights_cross_both_ways(gen_pair, disc_pair):
    """JAX -> reference layout (``export_srgan_generator``) -> the port;
    the port -> ``convert_srgan_generator`` /
    ``convert_srgan_discriminator`` -> JAX, with equal outputs."""
    jg, variables, pg = gen_pair
    x = _image((1, 9, 11, 3), 13)
    via_export = SRGANGenerator(num_residual=BLOCKS, device="meta")
    via_export.load_state_dict(export_srgan_generator(variables),
                               assign=True)
    with torch.no_grad():
        np.testing.assert_array_equal(
            via_export.eval()(torch.from_numpy(x)).numpy(),
            pg.eval()(torch.from_numpy(x)).numpy())
    back = convert_srgan_generator(pg.state_dict())
    np.testing.assert_array_equal(
        np.asarray(jg.apply(back, jnp.asarray(x), train=False)),
        np.asarray(jg.apply(variables, jnp.asarray(x), train=False)))
    jd, dvars, pd = disc_pair
    xd = jnp.asarray(_image((2, CROP, CROP, 3), 14))
    dback = convert_srgan_discriminator(pd.state_dict(), CROP)
    np.testing.assert_array_equal(
        np.asarray(jd.apply(dback, xd, train=False)),
        np.asarray(jd.apply(dvars, xd, train=False)))


def test_jax_ckpt_loads_in_the_port(gen_pair, tmp_path):
    _, variables, _ = gen_pair
    path = str(tmp_path / "srgan-gan-best.ckpt")
    jax_save(path, 4, "srgan-gan", variables)
    loaded = load_checkpoint(path, "srgan")
    assert (loaded["epoch"], loaded["phase"]) == (4, "srgan-gan")
    want = from_jax_variables(variables)
    assert list(loaded["state"]) == list(want)
    assert list(want) == list(SRGANGenerator(
        num_residual=BLOCKS, device="meta").state_dict())
    for key, value in want.items():
        assert torch.equal(loaded["state"][key], value), key


# ------------------------------------------------------------ the steps


@pytest.fixture(scope="module")
def jax_trainer():
    trainer = JaxTrainer(
        ts._args(model="srgan"), SyntheticTrainLoader(ts.BATCH, CROP,
                                                      n_batches=1),
        SyntheticEvalLoader(ts.BATCH, CROP, n_batches=1), 1, 1,
        make_mesh(num_devices=1), DistributedContext(1, -1, -1, 1, False))
    return trainer, jax.device_get(trainer.state)


def _port_trainer(host, vgg_params):
    trainer = SRGANTrainer(ts._args(model="srgan"),
                           types.SimpleNamespace(crop_size=CROP), None, 1,
                           1, device=torch.device("cpu"), logger=Logger())
    trainer.gen.load_state_dict(from_jax_variables(
        {"params": _np(host.gen_params),
         "batch_stats": _np(host.gen_stats)}))
    trainer.disc.load_state_dict(from_jax_variables(
        {"params": _np(host.disc_params),
         "batch_stats": _np(host.disc_stats)}))
    trainer.vgg.load_state_dict(from_jax_variables(
        {"params": _np(vgg_params)}))
    return trainer


def _assert_stats(jax_stats, port_stats):
    ours = _match_tree(jax_stats, port_stats)
    for a, b in zip(jax.tree.leaves(jax_stats), jax.tree.leaves(ours)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=ts.ATOL_STATS, rtol=ts.RTOL_STATS)


def test_pretrain_step_matches_jax(jax_trainer):
    jt, host = jax_trainer
    crops, flips = ts._batch()
    pt = _port_trainer(host, jt.vgg_params)
    state, loss_j = jt.pretrain_step(replicate(host, jt.mesh),
                                     *jt._put(crops, flips))
    loss = pt.pretrain_step(torch.from_numpy(crops), torch.from_numpy(flips))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=ts.RTOL_LOSS)
    state = jax.device_get(state)
    gen = convert_srgan_generator(pt.gen.state_dict())
    ts._assert_params_close(state.gen_params, gen["params"],
                            ts._grads(pt.gen, convert_srgan_generator),
                            ts.NOISE_GEN, "generator")
    # one train-mode generator forward updated the running statistics
    _assert_stats(state.gen_stats, gen["batch_stats"])
    assert pt.step == 1 and pt.gen.training


@pytest.mark.parametrize("disc_lr", [0.0, ts.LR], ids=["disc_lr0", "disc_lr"])
def test_gan_step_matches_jax(jax_trainer, disc_lr):
    """As the ESRGAN test: disc_lr 0 holds the generator's update,
    disc_lr = lr the discriminator's; both hold the running statistics
    of the generator (one forward) and of the discriminator (D(hr),
    D(sr) for its loss, then D(sr) for the generator's)."""
    jt, host = jax_trainer
    crops, flips = ts._batch()
    pt = _port_trainer(host, jt.vgg_params)
    state, met = jt.gan_step(replicate(host, jt.mesh),
                             *jt._put(crops, flips), ts.LR, disc_lr,
                             jt.vgg_params)
    got = pt.gan_step(torch.from_numpy(crops), torch.from_numpy(flips),
                      ts.LR, disc_lr)
    for key, rtol in (("disc_loss", ts.RTOL_DISC_LOSS),
                      ("gen_loss", ts.RTOL_LOSS)):
        assert torch.isfinite(got[key])
        np.testing.assert_allclose(float(got[key]), float(met[key]),
                                   rtol=rtol, err_msg=key)
    state = jax.device_get(state)
    gen = convert_srgan_generator(pt.gen.state_dict())
    disc = convert_srgan_discriminator(pt.disc.state_dict(), CROP)
    if disc_lr == 0.0:
        ts._assert_params_close(
            state.gen_params, gen["params"],
            ts._grads(pt.gen, convert_srgan_generator), ts.NOISE_GEN,
            "generator")
    else:
        ts._assert_params_close(
            state.disc_params, disc["params"],
            ts._grads(pt.disc, lambda sd: convert_srgan_discriminator(
                sd, CROP)), ts.NOISE_DISC, "discriminator")
    _assert_stats(state.gen_stats, gen["batch_stats"])
    _assert_stats(state.disc_stats, disc["batch_stats"])


def test_eval_step_uses_the_running_statistics(jax_trainer):
    """The trainer's eval runs the f32 generator in eval mode and leaves
    the statistics alone, like the JAX ``gen_eval`` (train=False)."""
    jt, host = jax_trainer
    pt = _port_trainer(host, jt.vgg_params)
    crops, _ = ts._batch()
    mask = np.ones(ts.BATCH, np.float32)
    before = {k: v.clone() for k, v in pt.gen.state_dict().items()}
    got = pt.eval_step(torch.from_numpy(crops), torch.from_numpy(mask))
    want = jt.eval_step(jt.state.gen_params, jt.state.gen_stats,
                        *jt._put(crops, mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    assert not pt.gen.training and pt.gen.compute_dtype is None
    for k, v in pt.gen.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_test_serve_srgan_on_the_cpu(tmp_path, monkeypatch):
    """``train --model srgan`` (both phases) -> ``test`` whole-image and
    tiled -> the daemon, on the CPU; no kernel of the port runs."""
    rng = np.random.default_rng(8)
    (tmp_path / "ds").mkdir()
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (36, 40, 3), np.uint8)).save(
            tmp_path / "ds" / f"img{i}.png")
    monkeypatch.chdir(tmp_path)
    before = (rdb_ops.RDB_FWD_LAUNCHES, rdb_ops.RDB_BWD_LAUNCHES)
    cli.main(["train", "--device", "cpu", "--model", "srgan",
              "--train-dir", "ds", "--gen-blocks", "1", "--vgg-convs", "2",
              "--crop-size", "32", "--batch-size", "3", "--epochs", "1",
              "--pretrain-epochs", "1", "--skip-image-save"])
    assert (rdb_ops.RDB_FWD_LAUNCHES, rdb_ops.RDB_BWD_LAUNCHES) == before
    best = load_checkpoint("srgan-gan-best.pth")
    assert best["phase"] == "srgan-gan" and best["extra"]["step"] == 6
    assert int(best["state"]["blocks.0.bn1.num_batches_tracked"]) == 6
    for extra in ([], ["--tile", "8", "--tile-overlap", "2"]):
        cli.main(["test", os.path.join("ds", "img0.png"), "--device", "cpu",
                  "--model", "srgan", "--checkpoint", "srgan-gan-best.pth",
                  *extra])
        with Image.open("upres-img0.png") as img:
            assert img.size == (40 * 4, 36 * 4)
    service = server.CheckpointUpscaleService(
        model="srgan", checkpoint="srgan-gan-best.pth", tile=16,
        tile_batch=2, device="cpu")
    assert service.meta["model"] == "srgan"
    httpd = server.make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        frame = rng.integers(0, 256, (20, 27, 3), np.uint8)
        body = _png(frame)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/upscale",
            data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = np.asarray(Image.open(io.BytesIO(resp.read())))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    gen = service._generator
    assert not gen.training
    want = tiled_upscale(gen, torch.from_numpy(frame).float() / 255.0,
                         tile=16, overlap=8, tile_batch=2)
    want = (want.clamp(0, 1) * 255 + 0.5).to(torch.uint8).numpy()
    assert got.shape == (80, 108, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()
