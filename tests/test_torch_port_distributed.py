"""The port's data parallelism against one process and the JAX package.

``parallel/mesh.py``'s environment parsing against the JAX
``detect_distributed`` for torchrun, Slurm and no launcher; the
training loader's shards against the JAX loader's, batch for batch;
then one pretrain step and one GAN step of each model's trainer, from
one JAX initial state (batch 4, ``--gen-blocks 1``, crop 32, f32): in
two processes over a gloo process group (2 crops each, gradients
averaged, BatchNorm statistics over the global batch), in one process
on the global batch, and in the JAX trainer.  The two-process state
equals the one-process state (Adam's first moments, i.e. the averaged
gradients, to rel 1e-4; parameters by ``_assert_params_close``'s rule;
BatchNorm running statistics to 1e-5), and the one-process state
equals JAX's (the rule and limits of tests/test_torch_port_train_step.py).
The workers run this file as a script (``python
test_torch_port_distributed.py worker ...``), one torch thread each,
one pair of them for both models; they also cast ``RankVote``'s
preemption vote, which both ranks read at the same call.
"""

import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import test_torch_port_multistep as tm
import test_torch_port_train_step as ts
from torchsr_tpu.data.loader import EvalLoader as JaxEvalLoader
from torchsr_tpu.data.loader import TrainLoader as JaxTrainLoader
from torchsr_tpu.data.synthetic import SyntheticEvalLoader as JaxSynthEval
from torchsr_tpu.data.synthetic import SyntheticTrainLoader as JaxSynthTrain
from torchsr_tpu.models.torch_compat import (
    convert_esrgan_generator,
    convert_srgan_generator,
)
from torchsr_tpu.parallel import mesh as jax_mesh
from torchsr_tpu.parallel.mesh import DistributedContext as JaxCtx
from torchsr_tpu.parallel.mesh import make_mesh, replicate
from torchsr_tpu.train.trainer import ESRGANTrainer as JaxESRGAN
from torchsr_tpu.train.trainer import SRGANTrainer as JaxSRGAN
from torchsr_tpu_torch.data.discovery import discover_images
from torchsr_tpu_torch.data.loader import EvalLoader, TrainLoader
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, CROP, LR = 4, 32, 1e-4
JAX = {"esrgan": (JaxESRGAN, convert_esrgan_generator),
       "srgan": (JaxSRGAN, convert_srgan_generator)}
# Adam's first moment after one step is 0.1 x the averaged gradient:
# the two-process average against the one-process mean differ by f32
# summation order, and, behind a BatchNorm, by its one-pass global
# moments against torch's two-pass ones: the ESRGAN discriminator's
# last BatchNorms normalize 4 values a channel at crop 32, where one
# element of 512 measured 1.4e-4 of its tensor's largest moment
RTOL_MOMENT, ATOL_MOMENT_FRAC = 1e-4, 1e-3
ATOL_RUNNING = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------- launcher


ENVS = {
    "none": {},
    "torchrun": {"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2",
                 "LOCAL_WORLD_SIZE": "4"},
    "slurm": {"SLURM_NTASKS": "4", "SLURM_PROCID": "3",
              "SLURM_LOCALID": "3", "SLURM_NTASKS_PER_NODE": "4"},
    "torchrun_over_slurm": {"WORLD_SIZE": "2", "RANK": "1",
                            "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
                            "SLURM_NTASKS": "4", "SLURM_PROCID": "3",
                            "SLURM_LOCALID": "3",
                            "SLURM_NTASKS_PER_NODE": "4"},
    "broken": {"WORLD_SIZE": "x", "RANK": "0", "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1"},
}
_LAUNCH_VARS = sorted({k for e in ENVS.values() for k in e})


@pytest.mark.parametrize("name", sorted(ENVS))
def test_environment_parsing_matches_jax(name, monkeypatch):
    """The port's context equals the JAX ``detect_distributed``'s for
    each launcher (one node: the JAX package starts no runtime), and
    Slurm's variables set ``RANK`` / ``WORLD_SIZE`` on both."""
    for key in _LAUNCH_VARS + ["RANK", "WORLD_SIZE"]:
        monkeypatch.delenv(key, raising=False)
    for key, value in ENVS[name].items():
        monkeypatch.setenv(key, value)
    want = jax_mesh.detect_distributed()
    jax_env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE")}
    env = dict(ENVS[name])
    got = mesh._env_context(env)
    assert (got.world_size, got.rank, got.local_rank, got.local_world_size,
            got.distributed, got.main_process) == (
        want.world_size, want.rank, want.local_rank, want.local_world_size,
        want.distributed, want.main_process)
    assert {k: env.get(k) for k in jax_env} == jax_env
    if name == "none":
        assert got == mesh.SINGLE and mesh.detect_distributed(env={}) == got


def test_num_devices_bounds_the_world_and_device_lists():
    ctx = mesh.DistributedContext(2, 1, 1, 2, True)
    mesh.check_num_devices(ctx, None)
    mesh.check_num_devices(ctx, 2)
    with pytest.raises(ValueError, match="--num-devices 4"):
        mesh.check_num_devices(ctx, 4)
    assert mesh.rank_device(ctx, "cuda") == torch.device("cuda", 1)
    assert mesh.rank_device(ctx, "cpu") == torch.device("cpu")
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        if not torch.cuda.is_available():
            mesh.detect_distributed(env=ENVS["torchrun"], device="cuda")
        else:
            raise RuntimeError("--device cpu (CUDA present: not checked)")


@pytest.mark.parametrize("shards", [2, 3])
def test_loader_shards_match_jax(image_dir, shards):
    """Each shard's batches (crops and flips) and eval crops equal the
    JAX loaders' at the same shard, over two epochs, with and without a
    shuffle window; the shards of an epoch cover every image."""
    paths = discover_images(image_dir)
    for window in (0, 3):
        seen = []
        for index in range(shards):
            kw = dict(dataset_multiplier=1, workers=2, seed=5,
                      num_shards=shards, shard_index=index,
                      shuffle_window=window)
            ours = TrainLoader(paths, 2, 16, **kw)
            theirs = JaxTrainLoader(paths, 2, 16, **kw)
            assert len(ours) == len(theirs)
            for epoch in (0, 3):
                for (c, f), (cj, fj) in zip(ours.epoch(epoch),
                                            theirs.epoch(epoch),
                                            strict=True):
                    np.testing.assert_array_equal(c, cj)
                    np.testing.assert_array_equal(f, fj)
                    if epoch == 0:
                        seen.extend(map(bytes, c))
            ev = EvalLoader(paths, 2, 16, seed=5, workers=2,
                            num_shards=shards, shard_index=index)
            evj = JaxEvalLoader(paths, 2, 16, seed=5, workers=2,
                                num_shards=shards, shard_index=index)
            assert len(ev) == len(evj)
            for (c, n), (cj, nj) in zip(ev, evj, strict=True):
                np.testing.assert_array_equal(c, cj)
                assert n == nj
        assert len(seen) == shards * len(ours) * 2


# ------------------------------------------------ the data-parallel step


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(payload_path, out_dir, world=2):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "WORLD_SIZE": str(world), "RANK": str(rank),
               "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
               "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.path.dirname(HERE) + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, os.path.basename(__file__)),
             "worker", str(port), str(payload_path), str(out_dir)],
            env=env, cwd=str(out_dir), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _port_trainer(model, payload, dist_ctx=mesh.SINGLE, batch=BATCH):
    from torchsr_tpu_torch.utils.logging import Logger

    trainer = tm.TRAINERS[model](
        ts._args(model=model, batch_size=batch),
        types.SimpleNamespace(crop_size=CROP), None, 1, 1,
        device=torch.device("cpu"),
        logger=Logger(main_process=dist_ctx.main_process),
        dist_ctx=dist_ctx)
    trainer.gen.load_state_dict(payload["gen"])
    trainer.disc.load_state_dict(payload["disc"])
    trainer.vgg.load_state_dict(payload["vgg"])
    return trainer


def _state(trainer) -> dict:
    """What the comparisons read: both modules' state dicts and the
    generator's and discriminator's Adam first moments by name."""
    out = {"gen": {k: v.clone() for k, v in trainer.gen.state_dict().items()},
           "disc": {k: v.clone()
                    for k, v in trainer.disc.state_dict().items()}}
    for key, opt, module in (("psnr", trainer.opt.psnr, trainer.gen),
                             ("gen_m", trainer.opt.gen, trainer.gen),
                             ("disc_m", trainer.opt.disc, trainer.disc)):
        out[key] = {n: opt.state[p]["exp_avg"].clone()
                    for n, p in module.named_parameters() if p in opt.state}
    out["grads"] = {n: p.grad.clone() for n, p in
                    trainer.gen.named_parameters() if p.grad is not None}
    return out


def _steps(model, payload, dist_ctx=mesh.SINGLE, part=slice(None)):
    """One pretrain step (batch A) and, from the same initial state, one
    GAN step (batch B, discriminator rate 0: its Adam moments still
    take the averaged gradients) on ``part`` of each batch."""
    batch = len(payload["crops_a"][part])
    pre = _port_trainer(model, payload, dist_ctx, batch)
    pre.pretrain_step(torch.from_numpy(payload["crops_a"][part]),
                      torch.from_numpy(payload["flips_a"][part]))
    gan = _port_trainer(model, payload, dist_ctx, batch)
    gan.gan_step(torch.from_numpy(payload["crops_b"][part]),
                 torch.from_numpy(payload["flips_b"][part]), LR, 0.0)
    return {"pretrain": _state(pre), "gan": _state(gan)}


VOTES = (False, True, False)  # rank 1's flag at three calls


def _worker(port, payload_path, out_dir):
    torch.set_num_threads(1)
    ctx = mesh.detect_distributed("127.0.0.1", port, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    payloads = torch.load(payload_path, weights_only=False)
    half = BATCH // ctx.world_size
    part = slice(ctx.rank * half, (ctx.rank + 1) * half)
    result = {model: _steps(model, payload, ctx, part)
              for model, payload in payloads.items()}
    vote = mesh.RankVote(torch.device("cpu"))
    result["votes"] = [vote.cast(flag and ctx.rank == 1) for flag in VOTES]
    result["votes"].append(vote.drain())
    torch.save(result, os.path.join(out_dir, f"rank{ctx.rank}.pt"))
    torch.distributed.destroy_process_group()


def _jax_model(model):
    """The JAX trainer of ``model`` at its initial state, and the
    payload the port's trainers start from: its state and two batches."""
    jt = JAX[model][0](
        ts._args(model=model, batch_size=BATCH),
        JaxSynthTrain(BATCH, CROP, n_batches=1),
        JaxSynthEval(BATCH, CROP, n_batches=1), 1, 1,
        make_mesh(num_devices=1), JaxCtx(1, -1, -1, 1, False))
    host = jax.device_get(jt.state)
    gen = {"params": ts._np(host.gen_params)}
    if host.gen_stats:
        gen["batch_stats"] = ts._np(host.gen_stats)
    (ca, fa), (cb, fb) = (tm._batches(1, seed=s, batch=BATCH)
                          for s in (3, 4))
    payload = {
        "gen": from_jax_variables(gen),
        "disc": from_jax_variables({"params": ts._np(host.disc_params),
                                    "batch_stats": ts._np(host.disc_stats)}),
        "vgg": from_jax_variables({"params": ts._np(jt.vgg_params)}),
        "crops_a": ca[0], "flips_a": fa[0], "crops_b": cb[0],
        "flips_b": fb[0]}
    return jt, host, payload


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    """Both models' JAX trainers and payloads, and one pair of gloo
    workers that runs both models' steps and the vote."""
    tmp = tmp_path_factory.mktemp("dp")
    models = {m: _jax_model(m) for m in JAX}
    torch.save({m: payload for m, (_, _, payload) in models.items()},
               tmp / "payload.pt")
    return models, _run_workers(tmp / "payload.pt", tmp)


@pytest.fixture(scope="module", params=["esrgan", "srgan"])
def dp_runs(request, worker_runs):
    model = request.param
    models, ranks = worker_runs
    jt, host, payload = models[model]
    single = _steps(model, payload)
    ca, fa, cb, fb = (payload[k] for k in ("crops_a", "flips_a", "crops_b",
                                           "flips_b"))
    state_a, _ = jt.pretrain_step(replicate(host, jt.mesh),
                                  *jt._put(ca, fa))
    state_b, _ = jt.gan_step(replicate(host, jt.mesh),
                             *jt._put(cb, fb), LR, 0.0, jt.vgg_params)
    return model, [r[model] for r in ranks], single, {
        "pretrain": jax.device_get(state_a), "gan": jax.device_get(state_b)}


def test_rank_vote_reads_one_call_late(worker_runs):
    """``RankVote``: rank 1 alone flags the second call; both ranks read
    it at the third cast, the same call, and the drain reads the last
    cast's (clear) vote."""
    _, ranks = worker_runs
    assert [r["votes"] for r in ranks] == [[False, False, True, False]] * 2


def _close_rule(want: dict, got: dict, grads: dict, what: str):
    """``_assert_params_close``'s rule between two port state dicts."""
    ts._assert_leaves_close(
        ((f"{what} {n}", want[n], got[n], grads[n]) for n in grads),
        ts.NOISE_GEN)


@pytest.mark.parametrize("phase", ["pretrain", "gan"])
def test_two_processes_equal_one_process(dp_runs, phase):
    """Both ranks hold the same state; it equals the one-process step on
    the global batch: the averaged gradients (Adam's first moments),
    the parameters, and every BatchNorm's running statistics (over the
    global batch)."""
    model, ranks, single, _ = dp_runs
    r0, r1, one = ranks[0][phase], ranks[1][phase], single[phase]
    for key in ("gen", "disc"):
        for name, v in r0[key].items():
            assert torch.equal(v, r1[key][name]), (phase, key, name)
    for key in ("psnr", "gen_m", "disc_m"):
        assert set(r0[key]) == set(one[key]), key
        for name, m in one[key].items():
            np.testing.assert_allclose(
                r0[key][name].numpy(), m.numpy(), rtol=RTOL_MOMENT,
                atol=ATOL_MOMENT_FRAC * float(m.abs().max()),
                err_msg=f"{model} {phase} {key} {name}")
    _close_rule(one["gen"], r0["gen"], one["grads"], f"{model} {phase}")
    stats = [(k, n) for k in ("gen", "disc") for n in one[k]
             if n.endswith(("running_mean", "running_var"))]
    assert stats or model == "esrgan"
    for key, name in stats:
        np.testing.assert_allclose(
            r0[key][name].numpy(), one[key][name].numpy(),
            atol=ATOL_RUNNING, rtol=1e-5, err_msg=f"{phase} {key} {name}")
    if model == "esrgan" and phase == "gan":
        assert any(n.endswith("running_mean") for n in one["disc"])


@pytest.mark.parametrize("phase", ["pretrain", "gan"])
def test_one_process_equals_jax(dp_runs, phase):
    """The one-process step on the global batch against the JAX
    trainer's: the pretrain step's generator by
    ``_assert_params_close``, the discriminator's BatchNorm statistics
    after the GAN step to ts.ATOL_STATS.  (The GAN step's generator
    update at batch 4 is held against JAX by
    tests/test_torch_port_multistep_jax.py, with the first moments'
    rule; from this batch, 4 of 18432 ESRGAN elements at 6.4% of their
    tensor's largest gradient take the other sign in Adam's first
    step.)"""
    model, _, single, jax_states = dp_runs
    convert = JAX[model][1]
    one, target = single[phase], jax_states[phase]
    if phase == "pretrain":
        grads = dict(one["gen"])
        grads.update(one["grads"])
        ts._assert_params_close(
            target.gen_params, convert(one["gen"])["params"],
            convert(grads)["params"], ts.NOISE_GEN, f"{model} generator")
    want = from_jax_variables({"params": ts._np(target.disc_params),
                               "batch_stats": ts._np(target.disc_stats)})
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                one["disc"][name].numpy(), w.numpy(), atol=ts.ATOL_STATS,
                rtol=ts.RTOL_STATS, err_msg=f"{phase} disc {name}")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(*sys.argv[2:5])
