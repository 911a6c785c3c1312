"""The training run's plumbing: async checkpoint writes, preemption,
``--fast-compile``, the kernel build cache and the resume from a JAX
``--fast-compile`` checkpoint.

The writer's semantics are the JAX ``AsyncCheckpointWriter``'s: its
files equal synchronous writes byte for byte, a newer save of a path
supersedes one not yet started, paths land first in first out, and an
error is sticky.  The preemption guard is the JAX one's; a CPU ``train``
that receives SIGTERM between host calls exits 0 with ``-latest``
written, and the resume re-runs the epoch.  A JAX checkpoint whose
optimizer moments are stacked (``blocks_scan``) resumes into the same
optimizer state as its unrolled twin, each moment the JAX one under the
port's layout.
"""

import os
import signal
import subprocess
import sys
import threading
import types
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models.esrgan import ESRGANDiscriminator as JaxDisc
from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxGen
from torchsr_tpu.models.scan_compat import stack_blocks as jax_stack
from torchsr_tpu.train.state import make_adam as jax_adam
from torchsr_tpu.utils.checkpoint import save_checkpoint as jax_save
from torchsr_tpu.utils.preemption import PreemptionGuard as JaxGuard
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.train.trainer import ESRGANTrainer
from torchsr_tpu_torch.utils import checkpoint as ckpt_mod
from torchsr_tpu_torch.utils import compile_cache
from torchsr_tpu_torch.utils.image_io import save_image
from torchsr_tpu_torch.utils.logging import Logger
from torchsr_tpu_torch.utils.preemption import (
    PreemptionGuard,
    TrainingPreempted,
)

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["--device", "cpu", "--gen-blocks", "1", "--vgg-convs", "2",
         "--crop-size", "32", "--batch-size", "2", "--skip-image-save"]


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    base = dict(batch_size=2, disable_amp=True, epochs=1, pretrain_epochs=1,
                gan_checkpoint=None, psnr_checkpoint=None, seed=0,
                skip_image_save=True, model="esrgan", num_residual=1,
                vgg_convs=2, metrics_file=None, vgg_weights=None)
    base.update(kw)
    return Namespace(**base)


def _trainer(**kw):
    return ESRGANTrainer(_args(**kw), types.SimpleNamespace(crop_size=32),
                         None, 1, 1, device=torch.device("cpu"),
                         logger=Logger())


# ----------------------------------------------------------- the writer

def test_async_writes_equal_sync_writes(tmp_path):
    tr = _trainer()
    state, extra = tr.gen.state_dict(), tr._full_state()
    writer = ckpt_mod.AsyncCheckpointWriter()
    writer.save(str(tmp_path / "a.pth"), 3, "esrgan-psnr", state, extra)
    ckpt_mod.save_checkpoint(str(tmp_path / "s.pth"), 3, "esrgan-psnr",
                             state, extra)
    writer.close()
    assert (tmp_path / "a.pth").read_bytes() == \
        (tmp_path / "s.pth").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))
    # the snapshot is taken at save(): a later in-place update of the
    # live weights does not reach the file
    with torch.no_grad():
        before = {k: v.clone() for k, v in tr.gen.state_dict().items()}
        writer.save(str(tmp_path / "b.pth"), 1, "p", tr.gen.state_dict())
        for p in tr.gen.parameters():
            p.add_(1.0)
    writer.wait()
    got = torch.load(tmp_path / "b.pth", weights_only=True)["state"]
    assert all(torch.equal(got[k], v) for k, v in before.items())
    writer.close()


@pytest.fixture
def gated(monkeypatch):
    """The writer's ``save_checkpoint`` held at a gate, recording the
    (path, epoch) it writes."""
    gate, written = threading.Event(), []
    real = ckpt_mod.save_checkpoint

    def slow(path, epoch, phase, state, extra=None):
        assert gate.wait(timeout=30)
        real(path, epoch, phase, state, extra)
        written.append((os.path.basename(path), epoch))

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow)
    return gate, written


def test_newer_saves_supersede_and_paths_land_in_order(tmp_path, gated):
    gate, written = gated
    writer = ckpt_mod.AsyncCheckpointWriter()
    sd = {"w": torch.zeros(2)}
    writer.save(str(tmp_path / "a.pth"), 0, "p", sd)  # taken by the worker
    for epoch in range(1, 4):
        writer.save(str(tmp_path / "b.pth"), epoch, "p", sd)
        writer.save(str(tmp_path / "c.pth"), epoch, "p", sd)
    assert writer.pending() == 3  # a in flight; b and c once each
    gate.set()
    writer.close()
    assert written == [("a.pth", 0), ("b.pth", 3), ("c.pth", 3)]
    assert writer.pending() == 0


def test_an_error_is_sticky(tmp_path):
    writer = ckpt_mod.AsyncCheckpointWriter()
    writer.save(str(tmp_path / "missing" / "x.pth"), 1, "p",
                {"w": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait()
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.save(str(tmp_path / "y.pth"), 1, "p", {"w": torch.zeros(1)})
    assert not (tmp_path / "y.pth").exists()
    with pytest.raises(RuntimeError):
        writer.close()


def test_sync_saves_and_preempt_flags_are_wired(monkeypatch):
    seen = {}

    def phase(self):
        seen[self.ckpt_writer is None] = signal.getsignal(signal.SIGTERM)

    monkeypatch.setattr(ESRGANTrainer, "_pretrain", phase)
    monkeypatch.setattr(ESRGANTrainer, "_gan_train", lambda self: None)
    default = signal.getsignal(signal.SIGTERM)
    tr = _trainer(sync_saves=True, no_preempt_save=True)
    tr.train()
    assert seen[True] is default
    tr = _trainer()
    assert isinstance(tr.ckpt_writer, ckpt_mod.AsyncCheckpointWriter)
    tr.train()
    assert getattr(seen[False], "__self__", None).__class__ is \
        PreemptionGuard
    assert signal.getsignal(signal.SIGTERM) is default
    args = cli.parse_args(["train"])
    assert (args.sync_saves, args.no_preempt_save, args.fast_compile,
            args.upscale_factor, args.data_workers, args.shuffle_window,
            args.sample_image) == (False, False, False, 4, 16, 0, None)


# ----------------------------------------------------------- preemption

@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JaxGuard],
                         ids=["port", "jax"])
def test_guard_latches_and_restores(guard_cls):
    before = signal.getsignal(signal.SIGTERM)
    with guard_cls() as guard:
        assert guard.active and not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert not guard.active
    assert signal.getsignal(signal.SIGTERM) is before
    box = {}

    def off_main():
        g = guard_cls().install()
        box["active"] = g.active
        box["handler"] = signal.getsignal(signal.SIGTERM)
        g.uninstall()

    thread = threading.Thread(target=off_main)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert box == {"active": False, "handler": before}


# Drives ``train`` in a process of its own and sends it SIGTERM from
# inside its second host call of the pretrain, so that the signal
# arrives between calls whatever the machine's speed.
_PREEMPTED = """
import os, signal, sys
sys.path.insert(0, {root!r})
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.train.trainer import GANTrainer
calls = []
real = GANTrainer._multi
def multi(self, *a, **kw):
    calls.append(1)
    if len(calls) == 2:
        os.kill(os.getpid(), signal.SIGTERM)
    return real(self, *a, **kw)
GANTrainer._multi = multi
cli.main(sys.argv[1:])
print("calls", len(calls))
"""


def test_sigterm_saves_latest_exits_zero_and_resumes(image_dir, tmp_path,
                                                     monkeypatch, capsys):
    monkeypatch.setenv("WANDB_MODE", "disabled")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    argv = ["train", "--train-dir", image_dir, *TRAIN, "--epochs", "1",
            "--pretrain-epochs", "1", "--steps-per-call", "1"]
    proc = subprocess.run(
        [sys.executable, "-c", _PREEMPTED.format(root=str(ROOT)), *argv],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "Preemption signal received: saved esrgan-psnr-latest.pth at " \
           "epoch 1" in proc.stdout
    assert "calls 2" in proc.stdout
    latest = torch.load(tmp_path / "esrgan-psnr-latest.pth",
                        weights_only=True)
    assert latest["epoch"] == 1 and latest["extra"]["step"] == 2
    assert not (tmp_path / "esrgan-gan-latest.pth").exists()
    monkeypatch.chdir(tmp_path)
    cli.main([*argv, "--sync-saves"])
    assert "Resuming pre-training from epoch 1" in capsys.readouterr().out
    # the epoch re-run: its 5 steps on top of the 2 saved
    latest = torch.load(tmp_path / "esrgan-psnr-latest.pth",
                        weights_only=True)
    assert latest["extra"]["step"] == 2 + 5
    assert (tmp_path / "esrgan-gan-latest.pth").exists()


def test_check_preemption_saves_and_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr = _trainer()
    tr._check_preemption(2, "esrgan-gan")  # no guard: nothing happens
    tr._preemption = types.SimpleNamespace(requested=True)
    with pytest.raises(TrainingPreempted):
        tr._check_preemption(2, "esrgan-gan")
    saved = torch.load("esrgan-gan-latest.pth", weights_only=True)
    assert saved["epoch"] == 2 and saved["phase"] == "esrgan-gan"
    tr.ckpt_writer.close()


# -------------------------------------------------------- fast compile

def test_fast_compile_gives_the_default_checkpoint(tmp_path, monkeypatch,
                                                  capsys):
    """Both runs on four seeded 40 x 40 images: one step a phase (on the
    CPU every step is eager either way; the card's check, both runs
    captured and equal, is ``chip_smoke.py``'s fast_compile phase).  The
    flag is accepted and logs its one line, once, and only under it."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        save_image(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8),
                   str(images / f"img_{i}.png"))
    files = {}
    for name, extra in (("default", []), ("fast", ["--fast-compile"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        capsys.readouterr()
        cli.main(["train", "--train-dir", str(images), *TRAIN, "--epochs",
                  "1", "--pretrain-epochs", "1", *extra])
        said = capsys.readouterr().out.count(
            "--fast-compile: the port has no long compile to shorten")
        assert said == (1 if extra else 0), (name, said)
        files[name] = torch.load("esrgan-gan-latest.pth", weights_only=True)
    a, b = files["default"], files["fast"]
    assert a["state"].keys() == b["state"].keys()
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert a["extra"]["step"] == b["extra"]["step"]


# ----------------------------------------------------------- build cache

def test_build_dir_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.kernel_build_dir() == ROOT / "build" / "kernels"
    from torchsr_tpu_torch.ops import _build

    assert _build.library_path("rdb_fwd").parent == ROOT / "build" / "kernels"
    installed = tmp_path / "site-packages" / "torchsr_tpu_torch"
    installed.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert compile_cache.kernel_build_dir(installed) == (
        tmp_path / "home" / ".cache" / "torchsr_tpu_torch" / "kernels")
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    assert compile_cache.kernel_build_dir() == tmp_path / "cache"
    assert _build.library_path("rdb_fwd").parent == tmp_path / "cache"
    monkeypatch.setenv(compile_cache.ENV, "0")
    fresh = compile_cache.kernel_build_dir()
    assert fresh.is_dir() and not any(fresh.iterdir())
    assert fresh == compile_cache.kernel_build_dir()  # one a process
    assert fresh.parent != ROOT / "build"


# ------------------------------------------- resume from a JAX checkpoint

@pytest.fixture(scope="module")
def jax_nets():
    """A 2-RRDB JAX ESRGAN generator's and a crop-32 discriminator's
    variables."""
    rng = np.random.default_rng(0)

    def init(net, shape):  # the trees' layout, traced, filled seeded
        tree = jax.eval_shape(lambda k: net.init(k, jnp.zeros(shape),
                                                 train=False),
                              jax.random.PRNGKey(0))
        return jax.tree.map(lambda a: rng.random(a.shape, np.float32),
                            dict(tree))

    return (init(JaxGen(num_rrdb_blocks=2, fused_rdb=False), (1, 8, 8, 3)),
            init(JaxDisc(image_size=32), (1, 32, 32, 3)))


def _jax_training_checkpoint(stacked: bool, path: str, nets) -> dict:
    """A JAX training checkpoint of ``nets``: the generator unrolled (as
    the JAX trainer saves it), the three optax Adam states with seeded
    moments, stacked when ``stacked`` (a ``--fast-compile`` run's
    layout)."""
    gen, disc = nets
    gen_p = gen["params"]
    rng = np.random.default_rng(5)

    def adam(params, count, layout):
        st = jax_adam().init(params)
        seeded = lambda p: rng.normal(size=p.shape).astype(np.float32)
        mu = layout(jax.tree.map(seeded, params))
        nu = layout(jax.tree.map(lambda p: np.abs(seeded(p)), params))
        return (st[0]._replace(count=np.int32(count), mu=mu, nu=nu), st[1])

    layout = jax_stack if stacked else (lambda t: t)
    extra = {
        "disc_params": disc["params"],
        "disc_stats": disc["batch_stats"],
        "psnr_opt_state": adam(gen_p, 7, layout),
        "gen_opt_state": adam(gen_p, 3, layout),
        "disc_opt_state": adam(disc["params"], 3, lambda t: t),
        "step": np.int32(7), "best_psnr": np.float32(21.5),
    }
    jax_save(path, 2, "esrgan-psnr", {"params": gen_p, "batch_stats": {}},
             extra=extra)
    return extra


def test_resume_from_a_stacked_jax_checkpoint(tmp_path, jax_nets):
    states = {}
    for stacked in (False, True):
        path = str(tmp_path / f"s{int(stacked)}.ckpt")
        extra = _jax_training_checkpoint(stacked, path, jax_nets)
        tr = _trainer(num_residual=2)
        epoch = tr._restore(ckpt_mod.load_checkpoint(path, "esrgan"),
                            "psnr")
        assert (epoch, tr.step, tr.best_psnr) == (2, 7, 21.5)
        states[stacked] = tr.opt.state_dict()
    a, b = states[False], states[True]
    for key in ("psnr_opt_state", "gen_opt_state", "disc_opt_state"):
        assert a[key]["state"].keys() == b[key]["state"].keys()
        for i, st in a[key]["state"].items():
            for name in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(st[name], b[key]["state"][i][name])
    # each moment is the JAX one under the port's layout
    names = [n for n, _ in tr.gen.named_parameters()]
    want = from_jax_variables({"params": extra["gen_opt_state"][0].mu})
    if "blocks_scan" in extra["gen_opt_state"][0].mu:
        from torchsr_tpu_torch.models.scan_compat import unroll_blocks

        want = from_jax_variables(
            {"params": unroll_blocks(extra["gen_opt_state"][0].mu)})
    got = a["gen_opt_state"]["state"]
    for i, name in enumerate(names):
        assert torch.equal(got[i]["exp_avg"], want[name])
        assert float(got[i]["step"]) == 3.0
    assert float(a["psnr_opt_state"]["state"][0]["step"]) == 7.0
