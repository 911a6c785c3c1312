"""The port's GAN phase against the JAX trainer's, epoch by epoch.

``_gan_train`` of both packages runs on the CPU from one state (f32,
``--gen-blocks 1``, crop 32, batch 4, ``--vgg-convs 2``) for four
epochs of three batches (``step_lr_schedule`` steps every epoch below
16 epochs), with two steps a call (one 2-step call and the ragged tail
an epoch).  Per epoch both are held on:

1. the generator's and discriminator's learning rates each step used;
2. the crops each step consumed: the train loader yields its batches
   in an order drawn from the epoch index it is asked for, so the
   order shows that both ask for ``shuffle_epoch = pre_epochs + epoch
   - 1``;
3. the eval PSNR on one validation set, and which epochs write
   ``-best`` (``best_psnr`` reset to -1 at the phase's start);
4. the parameters at the epoch's end, with the parameters, BatchNorm
   statistics and all Adam states re-synced from JAX's at the epoch's
   start (``_assert_params_close``'s rule of
   tests/test_torch_port_train_step.py over the epoch's steps, with the
   port's Adam first moments); where that rule cannot hold (epoch 1,
   below), against a witness: the port's own epoch from the same state
   moved by one float32 ulp.

A run without the re-sync prints how the generators part epoch by
epoch; nothing is asserted on it (the GAN phase is chaotic: rounding
differences grow).
"""

import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import test_torch_port_train_step as ts
from torchsr_tpu.data import synthetic as jax_synthetic
from torchsr_tpu.models.torch_compat import (
    convert_esrgan_generator,
    convert_srgan_generator,
)
from torchsr_tpu.parallel.mesh import DistributedContext, make_mesh
from torchsr_tpu.train.trainer import ESRGANTrainer as JaxESRGAN
from torchsr_tpu.train.trainer import SRGANTrainer as JaxSRGAN
from torchsr_tpu_torch.data import synthetic
from torchsr_tpu_torch.models.torch_compat import (
    from_jax_training_state,
    from_jax_variables,
)
from torchsr_tpu_torch.train.state import BASE_LR, step_lr_schedule
from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer

BATCH, CROP = 4, 32
EPOCHS, PRE_EPOCHS, N_BATCHES, K = 4, 2, 3, 2
TRAINERS = {"esrgan": (JaxESRGAN, ESRGANTrainer, convert_esrgan_generator),
            "srgan": (JaxSRGAN, SRGANTrainer, convert_srgan_generator)}
# the re-synced port's eval PSNR against JAX's: measured 0.0092 dB
# after epoch 1 (ESRGAN; Adam's sign-following first steps, below),
# at most 1.1e-4 dB after the later epochs
ATOL_PSNR = 2e-2
# the discriminator's decisive elements (its Adam first moment's share
# of its tensor's largest): its last BatchNorms normalize 4 values a
# channel, where rounding moves the update most (one GAN step holds it
# at 5%, ts.NOISE_DISC); measured from epoch 3 none beyond 5%, at
# ESRGAN's epoch 2 (Adam's count at 3) 17 of 9.5M elements beyond the
# rule, at most 12.4% of their tensor's largest
NOISE_DISC = {2: 0.25}
# epoch 1 (Adam's count from 0): the mean |port - JAX| over a module's
# parameters against the mean |port - port'|, port' the same epoch
# from the state moved by one ulp; measured 1.85 (ESRGAN generator),
# 2.17 (its discriminator), 2.18 and 0.85 (SRGAN's)
WITNESS_FACTOR = 4.0


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ShuffledLoader:
    """A synthetic train loader whose epoch ``i`` yields its batches in
    the order ``default_rng(i).permutation``; records each ``i`` asked
    for."""

    def __init__(self, base):
        self.base = base
        self.crop_size = base.crop_size
        self.batch_size = base.batch_size
        self.asked: list[int] = []

    def __len__(self):
        return len(self.base)

    @property
    def dataset_len(self):
        return self.base.dataset_len

    def epoch(self, idx):
        self.asked.append(idx)
        batches = list(self.base.epoch(idx))
        for b in np.random.default_rng(idx).permutation(len(batches)):
            yield batches[b]


def _args(model, metrics, vgg_convs=2):
    return ts._args(model=model, batch_size=BATCH, epochs=EPOCHS,
                    pretrain_epochs=PRE_EPOCHS, steps_per_call=K,
                    sync_saves=True, metrics_file=str(metrics),
                    vgg_convs=vgg_convs)


def _crop_id(crops) -> int:
    """Which synthetic batch ``crops`` is (its first bytes)."""
    return int(np.asarray(crops).reshape(-1)[:8].astype(np.int64) @
               (256 ** np.arange(8)))


def _psnrs(metrics) -> list:
    rows = [json.loads(line) for line in open(metrics)]
    return [r["gan/PSNR"] for r in rows if "gan/PSNR" in r]


def _run_jax(model, tmp_path, monkeypatch, crop=CROP, vgg_convs=2):
    """JAX's GAN phase at ``crop`` with the VGG trunk cut to
    ``vgg_convs`` convs (None: all 16); returns the state at each
    epoch's start and end (host copies), the steps' (gen_lr, disc_lr,
    batch ids), the epoch indices asked for, the PSNRs and the ``-best``
    epochs."""
    jax_cls = TRAINERS[model][0]
    loader = ShuffledLoader(jax_synthetic.SyntheticTrainLoader(
        BATCH, crop, n_batches=N_BATCHES))
    run_dir = tmp_path / f"jax-{model}"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    jt = jax_cls(_args(model, run_dir / "m.jsonl", vgg_convs), loader,
                 jax_synthetic.SyntheticEvalLoader(BATCH, crop, n_batches=1),
                 loader.dataset_len, BATCH, make_mesh(num_devices=1),
                 DistributedContext(1, -1, -1, 1, False))
    states = [jax.device_get(jt.state)]
    steps, bests = [], []
    multi, single, test, save = (jt.gan_step_multi, jt.gan_step, jt._test,
                                 jt._save)

    def gan_multi(state, crops_k, flips_k, gen_lr, disc_lr, vgg):
        steps.extend((gen_lr, disc_lr, _crop_id(c)) for c in crops_k)
        return multi(state, crops_k, flips_k, gen_lr, disc_lr, vgg)

    def gan_single(state, crops, flips, gen_lr, disc_lr, vgg):
        steps.append((gen_lr, disc_lr, _crop_id(crops)))
        return single(state, crops, flips, gen_lr, disc_lr, vgg)

    def record_test(epoch, phase, step):
        states.append(jax.device_get(jt.state))
        return test(epoch, phase, step)

    def record_save(epoch, phase, kind, **kw):
        if kind == "best":
            bests.append(epoch)
        return save(epoch, phase, kind, **kw)

    jt.gan_step_multi, jt.gan_step = gan_multi, gan_single
    jt._test, jt._save = record_test, record_save
    jt._gan_train()
    return {"states": states, "steps": steps, "asked": loader.asked,
            "psnr": _psnrs(run_dir / "m.jsonl"), "best": bests,
            "vgg": jax.device_get(jt.vgg_params)}


def _port_checkpoint(model, host, epoch):
    """JAX's host state as the checkpoint the port's ``_restore`` reads
    (what ``load_checkpoint`` makes of a JAX ``.ckpt``)."""
    gen = {"params": ts._np(host.gen_params)}
    if host.gen_stats:
        gen["batch_stats"] = ts._np(host.gen_stats)
    extra = {"disc_params": ts._np(host.disc_params),
             "disc_stats": ts._np(host.disc_stats),
             "step": np.asarray(host.step)}
    for key in ("psnr_opt_state", "gen_opt_state", "disc_opt_state"):
        extra[key] = serialization.to_state_dict(ts._np(getattr(host, key)))
    return {"epoch": epoch, "phase": f"{model}-gan",
            "state": from_jax_variables(gen),
            "extra": from_jax_training_state(extra,
                                             gen.get("batch_stats", {}))}


class _Stop(Exception):
    pass


def _ulp(module, seed):
    """Every parameter moved by one float32 ulp, up or down at random."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            up = torch.randint(0, 2, p.shape, generator=g).bool()
            p.copy_(torch.nextafter(p, torch.where(
                up, torch.tensor(np.inf), torch.tensor(-np.inf))))


def _run_port(model, tmp_path, monkeypatch, jax_run, resync, ulp=False,
              epochs=EPOCHS, crop=CROP, vgg_convs=2):
    """The port's GAN phase from JAX's initial state; with ``resync``
    each epoch starts from JAX's state at that epoch's start, with
    ``ulp`` moved by one ulp (``_ulp``); the first ``epochs`` epochs.
    Returns what ``_run_jax`` does, and at each epoch's end the
    generator's and discriminator's state dicts and their Adam first
    moments by name."""
    port_cls = TRAINERS[model][1]
    loader = ShuffledLoader(synthetic.SyntheticTrainLoader(
        BATCH, crop, n_batches=N_BATCHES))
    run_dir = tmp_path / f"port-{model}-{resync}-{ulp}"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    pt = port_cls(_args(model, run_dir / "m.jsonl", vgg_convs), loader,
                  synthetic.SyntheticEvalLoader(BATCH, crop, n_batches=1),
                  loader.dataset_len, BATCH, device=torch.device("cpu"))
    pt.vgg.load_state_dict(from_jax_variables(
        {"params": ts._np(jax_run["vgg"])}))
    pt._restore(_port_checkpoint(model, jax_run["states"][0], 1), "gan")
    pt.best_psnr = -1.0
    ends, steps, bests = [], [], []
    epoch_fn, body, test, save = (pt._stacked_epoch, pt._gan_body, pt._test,
                                  pt._save)

    def stacked_epoch(shuffle_epoch, *a, epoch=1, **kw):
        if epoch > epochs:
            raise _Stop
        if resync:
            best = pt.best_psnr
            pt._restore(_port_checkpoint(
                model, jax_run["states"][epoch - 1], epoch), "gan")
            pt.best_psnr = best
            if ulp:
                _ulp(pt.gen, epoch)
                _ulp(pt.disc, -epoch)
        return epoch_fn(shuffle_epoch, *a, epoch=epoch, **kw)

    def gan_body(crops, flips):
        steps.append((float(pt.opt.gen.param_groups[0]["lr"]),
                      float(pt.opt.disc.param_groups[0]["lr"]),
                      _crop_id(crops)))
        return body(crops, flips)

    def record_test(epoch, phase, step):
        ends.append(({k: v.clone() for k, v in pt.gen.state_dict().items()},
                     {k: v.clone() for k, v in pt.disc.state_dict().items()},
                     {n: pt.opt.gen.state[p]["exp_avg"].clone()
                      for n, p in pt.gen.named_parameters()},
                     {n: pt.opt.disc.state[p]["exp_avg"].clone()
                      for n, p in pt.disc.named_parameters()}))
        return test(epoch, phase, step)

    def record_save(epoch, phase, kind):
        if kind == "best":
            bests.append(epoch)
        return save(epoch, phase, kind)

    pt._stacked_epoch, pt._gan_body = stacked_epoch, gan_body
    pt._test, pt._save = record_test, record_save
    try:
        pt._gan_train()
    except _Stop:
        pass
    return {"ends": ends, "steps": steps, "asked": loader.asked,
            "psnr": _psnrs(run_dir / "m.jsonl"), "best": bests}


def all_runs(model, tmp_path, **size):
    """JAX's run, the port's re-synced, one-ulp (epoch 1) and free runs
    (``size``: ``crop``, ``vgg_convs``)."""
    with pytest.MonkeyPatch.context() as mp:
        jax_run = _run_jax(model, tmp_path, mp, **size)
        resynced = _run_port(model, tmp_path, mp, jax_run, True, **size)
        moved = _run_port(model, tmp_path, mp, jax_run, True, ulp=True,
                          epochs=1, **size)
        free = _run_port(model, tmp_path, mp, jax_run, False, **size)
    return model, jax_run, resynced, free, moved


@pytest.fixture(scope="module", params=["esrgan", "srgan"])
def runs(request, tmp_path_factory):
    return all_runs(request.param, tmp_path_factory.mktemp(request.param))


def test_learning_rates_and_data_order_per_step(runs):
    """Each step's two learning rates and batch, and the epoch indices
    asked of the loader, equal JAX's; the rates step every epoch."""
    model, jax_run, port, free, _ = runs
    want = [step_lr_schedule(BASE_LR, e, EPOCHS)
            for e in range(1, EPOCHS + 1) for _ in range(N_BATCHES)]
    assert len(set(want)) == EPOCHS
    for run in (port, free):
        assert run["asked"] == jax_run["asked"] == [
            PRE_EPOCHS + e - 1 for e in range(1, EPOCHS + 1)]
        assert len(run["steps"]) == len(jax_run["steps"]) == len(want)
        for i, ((g, d, b), (gj, dj, bj), w) in enumerate(
                zip(run["steps"], jax_run["steps"], want)):
            assert g == pytest.approx(float(gj), rel=1e-6) == w, i
            assert d == pytest.approx(float(dj), rel=1e-6) == w, i
            assert b == bj, (i, "batch order")


def test_eval_psnr_and_best_epochs(runs):
    """The re-synced port's eval PSNR at each epoch's end within
    ``ATOL_PSNR`` dB of JAX's, and the same epochs write ``-best``."""
    model, jax_run, port, _, _ = runs
    assert len(port["psnr"]) == len(jax_run["psnr"]) == EPOCHS
    np.testing.assert_allclose(port["psnr"], jax_run["psnr"], atol=ATOL_PSNR)
    assert port["best"] == jax_run["best"] and port["best"][0] == 1


def _torch_named(params, stats) -> dict:
    """A JAX host state's module as the port's ``state_dict``."""
    variables = {"params": ts._np(params)}
    if stats:
        variables["batch_stats"] = ts._np(stats)
    return {k: v.numpy() for k, v in from_jax_variables(variables).items()}


def test_resynced_epochs_match_jax_parameters(runs):
    """From JAX's state at each epoch's start, the port's generator and
    discriminator at the epoch's end against JAX's, by
    ``_assert_params_close``'s rule over the epoch's steps at its rate,
    with the port's Adam first moments: the generator from epoch 2 (no
    element beyond it, max |diff| 1.2e-4 at epoch 2), the
    discriminator's parameters from epoch 2 (decisive above
    ``NOISE_DISC``), its BatchNorm statistics from epoch 2 to
    ts.ATOL_STATS a step and ts.RTOL_STATS (measured 5.5e-3 at epoch
    2).  Epoch 1 is ``test_first_epoch_within_its_rounding_witness``'s."""
    model, jax_run, port, _, _ = runs
    for e, (gen_sd, disc_sd, gen_m, disc_m) in enumerate(port["ends"]):
        if not e:
            continue
        target = jax_run["states"][e + 1]
        lr = step_lr_schedule(BASE_LR, e + 1, EPOCHS)
        what = f"{model}, epoch {e + 1}"
        _close(_torch_named(target.gen_params, target.gen_stats), gen_sd,
               gen_m, lr, ts.NOISE_GEN, f"{what} generator")
        want = _torch_named(target.disc_params, target.disc_stats)
        assert set(want) == set(disc_sd)
        _close(want, disc_sd, disc_m, lr, NOISE_DISC.get(e + 1, ts.NOISE_GEN),
               f"{what} discriminator")
        for name, w in want.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(
                    disc_sd[name].numpy(), w, rtol=ts.RTOL_STATS,
                    atol=N_BATCHES * ts.ATOL_STATS,
                    err_msg=f"{what} discriminator {name}")


def test_first_epoch_within_its_rounding_witness(runs):
    """Epoch 1 starts Adam from a count of 0: its first step moves every
    element by the sign of its gradient, so an element whose gradient
    rounding flips moves a full step the other way, and the next steps'
    gradients follow (16% of the ESRGAN generator's elements end beyond
    the per-step limits, and elements with decisive moments among
    them).  The witness that this is rounding: the port's own epoch 1
    from JAX's state moved by one ulp parts from the port's the same
    way (measured: ESRGAN's generator 928-1039 decisive elements
    beyond the rule, its discriminator 66,555-66,628).  Held: each
    module's mean |port - JAX| within ``WITNESS_FACTOR`` of its mean
    |port - port'|, and every element within two opposite steps a
    step."""
    model, jax_run, port, _, moved = runs
    lr = step_lr_schedule(BASE_LR, 1, EPOCHS)
    target = jax_run["states"][1]
    (gen_sd, disc_sd, gen_m, disc_m), (gen_u, disc_u, _, _) = (
        port["ends"][0], moved["ends"][0])
    for what, want, got, other, names in (
            ("generator", _torch_named(target.gen_params, target.gen_stats),
             gen_sd, gen_u, gen_m),
            ("discriminator",
             _torch_named(target.disc_params, target.disc_stats), disc_sd,
             disc_u, disc_m)):
        gap = _mean_gap(want, got, names)
        witness = _mean_gap({n: other[n].numpy() for n in names}, got, names)
        assert 0 < witness and gap <= WITNESS_FACTOR * witness, (
            f"{model} epoch 1 {what}: mean |port - JAX| {gap:.3g} against "
            f"the one-ulp witness {witness:.3g}")
        for n in names:
            assert float(np.abs(want[n] - got[n].numpy()).max()) <= (
                N_BATCHES * 2.1 * lr), f"{model} epoch 1 {what} {n}"


def _mean_gap(want: dict, got: dict, names) -> float:
    """The mean |want - got| over the parameters ``names``."""
    total = count = 0.0
    for n in names:
        d = np.abs(np.asarray(want[n], np.float64)
                   - got[n].double().numpy())
        total += float(d.sum())
        count += d.size
    return total / count


def test_free_run_gap_per_epoch(runs, capsys):
    """Without the re-sync: how far the port's generator lies from
    JAX's at each epoch's end (printed, not asserted)."""
    model, jax_run, _, free, _ = runs
    convert = TRAINERS[model][2]
    gaps = []
    for e, (gen_sd, *_rest) in enumerate(free["ends"]):
        got = _flat(convert(gen_sd)["params"])
        want = _flat(jax_run["states"][e + 1].gen_params)
        gaps.append(float(np.abs(got - want).max()))
    with capsys.disabled():
        print(f"\n{model} free-run generator gap by epoch (max abs): "
              + ", ".join(f"{g:.3g}" for g in gaps)
              + f"; PSNR port {np.round(free['psnr'], 3).tolist()} "
              f"JAX {np.round(jax_run['psnr'], 3).tolist()}")
    assert len(gaps) == EPOCHS and all(np.isfinite(gaps))


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(a, np.float64))
                           for a in jax.tree.leaves(tree)])


def _close(want: dict, got: dict, moments: dict, lr, noise, what):
    """``_assert_params_close``'s rule over an epoch of ``N_BATCHES``
    steps at ``lr``, parameter by parameter (``moments``' names; JAX's
    in ``want``): elements whose Adam first moment is decisive (at least
    ``noise`` of its tensor's largest) to (ATOL_PARAM, RTOL_PARAM) per
    step, every element within two opposite steps a step, at most 10%
    (or 4 elements) of a tensor beyond."""
    for name, m in moments.items():
        where = f"{what} {name}"
        a = np.asarray(want[name], np.float64)
        b = got[name].double().numpy()
        g = np.abs(m.double().numpy())
        assert a.shape == b.shape, where
        bad = np.abs(a - b) > N_BATCHES * (
            ts.ATOL_PARAM + ts.RTOL_PARAM * np.abs(b))
        decisive = g >= max(1e-7, noise * float(g.max()))
        assert not (bad & decisive).any(), (
            f"{where}: {int((bad & decisive).sum())}/{a.size} decisive "
            f"elements beyond tolerance, max |diff| "
            f"{float(np.abs(a - b)[bad & decisive].max()):.3g}")
        assert float(np.abs(a - b).max()) <= N_BATCHES * 2.1 * lr, where
        assert float(bad.mean()) < 0.10 or int(bad.sum()) <= 4, (
            f"{where}: {int(bad.sum())}/{a.size} beyond")
