"""The port's multi-step training programs and what feeds and measures
them, on the CPU.

The synthetic loaders and the stacked prefetch against the JAX
package's; ``pretrain_step_multi`` and ``gan_step_multi`` against the
same single steps (bit for bit: on the CPU a K-step call runs K eager
steps; tests/test_torch_port_multistep_jax.py holds them against the
JAX trainer's multi-step programs); the epoch loop's calls, ragged tail, logged steps and loss transfers;
the step profiler's window; the optimizers' checkpoint loading across
device kinds; the CLI's new flags; and ``tools/bench.py``'s five lines
at a tiny size.  Everything runs in f32 at ``--gen-blocks 1``, crop 32,
batch 2.  The CUDA graphs themselves run only on the card
(``chip_smoke.py``'s multistep phase).
"""

import functools
import io
import json
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import test_torch_port_train_step as ts
from torchsr_tpu.data import prefetch as jax_prefetch
from torchsr_tpu.data import synthetic as jax_synthetic
from torchsr_tpu.parallel.mesh import make_mesh
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.data import synthetic
from torchsr_tpu_torch.data.prefetch import prefetch_to_device_stacked
from torchsr_tpu_torch.tools import bench
from torchsr_tpu_torch.train.state import Optimizers, make_adam
from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer
from torchsr_tpu_torch.utils.logging import Logger
from torchsr_tpu_torch.utils.profiling import StepProfiler

CROP = ts.CROP
TRAINERS = {"esrgan": ESRGANTrainer, "srgan": SRGANTrainer}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each step here is tiny: on one intra-op thread it runs as fast as
    on all of them, and the test workers that share the machine do not
    wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- feeding


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_loaders_are_jax_byte_for_byte(seed):
    ours = synthetic.SyntheticTrainLoader(3, 16, n_batches=4, seed=seed)
    theirs = jax_synthetic.SyntheticTrainLoader(3, 16, n_batches=4,
                                                seed=seed)
    assert (len(ours), ours.dataset_len, ours.crop_size) == (
        len(theirs), theirs.dataset_len, theirs.crop_size) == (4, 12, 16)
    for (c, f), (cj, fj) in zip(ours.epoch(7), theirs.epoch(7),
                                strict=True):
        assert c.dtype == np.uint8 and f.dtype == np.bool_
        np.testing.assert_array_equal(c, cj)
        np.testing.assert_array_equal(f, fj)
    ev = synthetic.SyntheticEvalLoader(2, 16, n_batches=3, seed=seed)
    evj = jax_synthetic.SyntheticEvalLoader(2, 16, n_batches=3, seed=seed)
    assert (len(ev), ev.dataset_len, ev.batch_size) == (3, 6, 2)
    for (c, n), (cj, nj) in zip(ev, evj, strict=True):
        np.testing.assert_array_equal(c, cj)
        assert n == nj == 2


@pytest.mark.parametrize("k", [1, 3, 8])
def test_stacked_prefetch_groups_like_jax(k):
    """7 batches: full groups of k as one stacked "multi" item, the
    ragged tail (and everything at k = 1) as "single" items."""
    loader = synthetic.SyntheticTrainLoader(2, 8, n_batches=7)
    ours = list(prefetch_to_device_stacked(loader.epoch(0), "cpu", k))
    theirs = list(jax_prefetch.prefetch_to_device_stacked(
        loader.epoch(0), make_mesh(num_devices=1), k))
    assert [kind for kind, _ in ours] == [kind for kind, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        for x, y in zip(a, b, strict=True):
            assert isinstance(x, torch.Tensor)
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    want = ["multi"] * (7 // k if k > 1 else 0)
    want += ["single"] * (7 - k * len(want))
    assert [kind for kind, _ in ours] == want


def test_stacked_prefetch_hands_on_the_producers_error():
    def batches():
        yield np.zeros((2, 4, 4, 3), np.uint8), np.zeros((2, 2), bool)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device_stacked(batches(), "cpu", 2))


# --------------------------------------------------- K steps, one call


def _batches(k, seed=42, batch=ts.BATCH):
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (k, batch, CROP, CROP, 3), np.uint8)
    flips = rng.random((k, batch, 2)) < 0.5
    return crops, flips


def _trainer(model, batch=ts.BATCH):
    return TRAINERS[model](ts._args(model=model, batch_size=batch),
               types.SimpleNamespace(crop_size=CROP), None, 1, 1,
               device=torch.device("cpu"), logger=Logger())


def _state(trainer):
    out = {f"gen.{k}": v for k, v in trainer.gen.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in trainer.disc.state_dict().items()})
    for name, opt in zip(("psnr", "gen", "disc"), trainer.opt.all()):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("model", ["esrgan", "srgan"])
@pytest.mark.parametrize("phase", ["pretrain", "gan"])
def test_multi_equals_single_steps_bit_for_bit(model, phase):
    """A K-step call (pretrain K = 3, GAN K = 2) equals K single steps:
    losses, parameters, BatchNorm statistics, Adam state, step count."""
    k = 3 if phase == "pretrain" else 2
    crops, flips = map(torch.from_numpy, _batches(k))
    single, multi = _trainer(model), _trainer(model)
    if phase == "pretrain":
        want = [single.pretrain_step(c, f) for c, f in zip(crops, flips)]
        got = {"loss": multi.pretrain_step_multi(crops, flips)}
        want = {"loss": torch.stack(want)}
    else:
        rows = [single.gan_step(c, f, ts.LR, ts.LR / 2)
                for c, f in zip(crops, flips)]
        want = {key: torch.stack([r[key] for r in rows])
                for key in ("disc_loss", "gen_loss")}
        got = multi.gan_step_multi(crops, flips, ts.LR, ts.LR / 2)
    for key in want:
        assert got[key].shape == (k,)
        assert torch.equal(got[key], want[key]), key
    a, b = _state(single), _state(multi)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert single.step == multi.step == k


# ----------------------------------------------------------- the epoch


class _CountedReads(torch.Tensor):
    """A loss vector that counts its reads to the host."""

    reads: list = []

    def tolist(self):
        self.reads.append("tolist")
        return super().tolist()

    def item(self):
        self.reads.append("item")
        return super().item()

    def __float__(self):
        self.reads.append("float")
        return super().__float__()


def test_epoch_runs_k_a_call_with_a_tail_and_one_transfer(tmp_path):
    """5 batches at K = 2: two 2-step calls and a 1-step tail; the five
    per-step losses logged at the reference's steps; one host transfer
    of the losses a call (``tolist``), no per-step ``float``/``item``."""
    tr = _trainer("esrgan")
    tr.train_loader = synthetic.SyntheticTrainLoader(ts.BATCH, CROP,
                                                     n_batches=5)
    tr.logger = Logger(metrics_path=str(tmp_path / "m.jsonl"))
    calls, reads = [], []

    def recording(crops_k, flips_k):
        calls.append(len(crops_k))
        losses = tr.pretrain_step_multi(crops_k, flips_k)
        out = losses.as_subclass(_CountedReads)
        out.reads = reads
        return out

    step, _ = tr._stacked_epoch(0, 100, 2, recording,
                                lambda lv: {"psnr/train-loss": lv})
    tr.logger.finish()
    assert calls == [2, 2, 1]
    assert reads == ["tolist"] * 3
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows] == [100 + j * ts.BATCH
                                          for j in range(5)]
    assert all(np.isfinite(r["psnr/train-loss"]) for r in rows)
    assert step == 100 + 4 * ts.BATCH and tr.step == 5


def test_step_profiler_window(tmp_path):
    """It starts once more than 2 steps were seen, counts K per call,
    stops after ``num_steps`` and writes one trace, once a run."""
    logger = types.SimpleNamespace(lines=[])
    logger.log = logger.lines.append
    prof = StepProfiler(3, str(tmp_path / "t"), logger)
    prof.step(2)
    assert prof._prof is None
    prof.step(2)  # 4 seen: the window opens
    assert prof._prof is not None
    torch.ones(4).sum()
    prof.step(2)
    assert prof._prof is not None  # 2 of 3 steps
    prof.step(2)
    assert prof._prof is None and (tmp_path / "t" / "trace.json").exists()
    json.loads((tmp_path / "t" / "trace.json").read_text())
    prof.step(8)
    prof.stop()
    assert [p.name for p in (tmp_path / "t").iterdir()] == ["trace.json"]
    assert logger.lines == [f"Wrote 4-step profiler trace to "
                            f"{tmp_path / 't' / 'trace.json'}"]
    idle = StepProfiler(0, str(tmp_path / "none"))
    idle.step(10)
    idle.stop()
    assert not (tmp_path / "none").exists()


def test_optimizers_load_a_card_checkpoint_on_the_cpu():
    """A state written by the card's optimizers (learning rate a tensor,
    fused and capturable) loads into the CPU's: float rates, the CPU's
    flags, step counts on the host; the next step runs."""
    net = torch.nn.Linear(3, 2)
    opts = Optimizers(net, torch.nn.Linear(2, 1))
    net(torch.ones(1, 3)).sum().backward()
    opts.psnr.step()
    state = opts.state_dict()
    for group in state["psnr_opt_state"]["param_groups"]:
        group.update(lr=torch.tensor(5e-5), fused=True, capturable=True)
    fresh = Optimizers(net, torch.nn.Linear(2, 1))
    fresh.load_state_dict(state)
    group = fresh.psnr.param_groups[0]
    assert group["lr"] == pytest.approx(5e-5) and not isinstance(
        group["lr"], torch.Tensor)
    assert not group["capturable"] and not group["fused"]
    st = fresh.psnr.state[net.weight]
    assert st["step"].device.type == "cpu" and float(st["step"]) == 1.0
    fresh.psnr.step()
    assert float(fresh.psnr.state[net.weight]["step"]) == 2.0
    assert isinstance(make_adam(net.parameters()).param_groups[0]["lr"],
                      float)


def test_cli_parses_the_multistep_and_profile_flags():
    args = cli.parse_args(["train"])
    assert (args.steps_per_call, args.profile_steps, args.profile_dir) == (
        None, 0, "traces")
    args = cli.parse_args(["train", "--steps-per-call", "3",
                           "--profile-steps", "5", "--profile-dir", "tr"])
    assert (args.steps_per_call, args.profile_steps, args.profile_dir) == (
        3, 5, "tr")
    for bad in ("0", "-2", "x"):
        with pytest.raises(SystemExit):
            cli.parse_args(["train", "--steps-per-call", bad])
    tr = ESRGANTrainer(ts._args(steps_per_call=3),
                       types.SimpleNamespace(crop_size=CROP), None, 1, 1,
                       device=torch.device("cpu"), logger=Logger())
    assert (tr.steps_per_call, tr.gan_steps_per_call) == (3, 3)
    assert (_trainer("esrgan").steps_per_call,
            _trainer("esrgan").gan_steps_per_call) == (8, 2)
    assert _trainer("srgan").gan_steps_per_call == 8


# --------------------------------------------------------------- bench


TINY = {
    "bench_esrgan_gan": dict(batch=2, crop=32, steps=2, num_residual=1,
                             vgg_convs=2),
    "bench_srgan_gan": dict(batch=2, crop=16, steps=8, num_residual=1,
                            vgg_convs=2),
    "bench_esrgan_tiled_inference": dict(frame_hw=(20, 36), tile=16,
                                         overlap=4, tile_batch=2, frames=1,
                                         num_residual=1),
    "bench_tiled_inference": dict(frame_hw=(20, 36), tile=16, overlap=4,
                                  tile_batch=2, frames=1, num_residual=1),
    "bench_srgan_train": dict(batch=2, crop=16, warmup_steps=1,
                              measure_steps=8, num_residual=1),
}
METRICS = ["esrgan_gan_step_crops_per_sec_per_chip",
           "srgan_gan_step_crops_per_sec_per_chip",
           "esrgan_tiled_infer_output_mp_per_sec",
           "srgan_tiled_infer_output_mp_per_sec",
           "srgan_train_crops_per_sec_per_chip"]


def _run_bench(monkeypatch, stubs=None):
    """``bench.main`` on the CPU with each metric at ``TINY`` size, or
    replaced by ``stubs[name]``."""
    for name, kw in TINY.items():
        fn = (stubs or {}).get(name) or functools.partial(
            getattr(bench, name), **kw)
        monkeypatch.setattr(bench, name, fn)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--device", "cpu"])
    return rc, [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]


def test_bench_prints_the_five_metrics_headline_last(monkeypatch):
    rc, lines = _run_bench(monkeypatch)
    assert rc == 0
    assert [ln["metric"] for ln in lines] == METRICS
    for ln in lines:
        # rounded to 0.01 like bench.py's: a tiny CPU rate may read 0
        assert np.isfinite(ln["value"]) and ln["value"] >= 0
        assert (ln["device"], ln["power_limit_w"]) == ("cpu", None)
        base = {METRICS[0]: 40.0, METRICS[1]: 150.0, METRICS[2]: 2.0,
                METRICS[3]: 20.0, METRICS[4]: 500.0}[ln["metric"]]
        # the value is rounded to 0.01, the ratio to 0.001
        assert ln["vs_baseline"] == pytest.approx(
            ln["value"] / base, abs=0.005 / base + 5e-4)


def test_bench_exits_non_zero_after_the_others_print(monkeypatch, capsys):
    def stub(metric):
        def fn(device):
            return bench._line(metric, 1.0, "stub", 1.0, torch.device(device))
        return fn

    def broken(device):
        raise RuntimeError("metric broke")

    stubs = {name: stub(metric) for name, metric in zip(TINY, METRICS)}
    stubs["bench_srgan_gan"] = broken
    rc, lines = _run_bench(monkeypatch, stubs)
    assert rc == 1
    assert [ln["metric"] for ln in lines] == [m for m in METRICS
                                              if m != METRICS[1]]
    assert "metric broke" in capsys.readouterr().err


def test_bench_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_srgan_train(device="cuda")
