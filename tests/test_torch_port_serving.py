"""The port's serving path against the JAX package's, on the CPU.

Tiled upscaling, checkpoints (.pth written by the port, .ckpt written
by the JAX package), the ``test`` runner and the HTTP daemon.  The same
JAX-initialised weights go to both packages; inputs come from numpy
with a seed; everything runs in f32 with ``device="cpu"``.
"""

import argparse
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.infer.tiled import tiled_upscale as jax_tiled_upscale
from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxGenerator
from torchsr_tpu.utils.checkpoint import save_checkpoint as jax_save
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.infer import runner, server
from torchsr_tpu_torch.infer.tiled import tiled_upscale
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.utils.checkpoint import (
    find_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

# f32 through one RRDB and the overlap-add; measured ~1e-7.
ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One set of 1-RRDB ESRGAN weights as JAX variables, as a port
    .pth and as a JAX .ckpt."""
    gen = JaxGenerator(num_rrdb_blocks=1)
    variables = jax.tree.map(np.asarray, dict(gen.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)), train=False)))
    root = tmp_path_factory.mktemp("torch_port_ckpt")
    pth = str(root / "esrgan-gan-best.pth")
    save_checkpoint(pth, 3, "gan", from_jax_variables(variables))
    ckpt = str(root / "jax" / "esrgan-gan-best.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    jax_save(ckpt, 3, "gan", variables)
    return gen, variables, pth, ckpt


def _port_generator(variables):
    gen = ESRGANGenerator(num_rrdb_blocks=1, device="meta")
    gen.load_state_dict(from_jax_variables(variables), assign=True)
    return gen.requires_grad_(False)


@pytest.mark.parametrize(
    "hw, tile, overlap, tile_batch",
    [
        ((40, 52), 16, 4, 3),  # 12 tiles: 4 chunks, none padded
        ((44, 52), 16, 4, 5),  # 16 tiles: the last chunk padded
        ((10, 12), 16, 4, 2),  # smaller than a tile: reflect-padded
        ((20, 13), 16, 0, 4),  # no overlap, one side padded
    ],
)
def test_tiled_upscale_matches_jax(weights, hw, tile, overlap, tile_batch):
    gen, variables, _, _ = weights
    image = np.random.default_rng(sum(hw)).random((*hw, 3), np.float32)

    def jax_infer(v, batch):
        return gen.apply(v, batch, train=False)

    want = np.asarray(jax_tiled_upscale(
        jax_infer, jnp.asarray(image), scale=4, tile=tile,
        overlap=overlap, tile_batch=tile_batch, params=variables,
    ))
    calls = []
    port = _port_generator(variables)

    def infer(batch):
        calls.append(batch.shape[0])
        return port(batch)

    got = tiled_upscale(infer, torch.from_numpy(image), scale=4, tile=tile,
                        overlap=overlap, tile_batch=tile_batch)
    assert got.shape == (hw[0] * 4, hw[1] * 4, 3)
    assert set(calls) == {tile_batch}
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_tiled_upscale_rejects_overlap_not_below_tile():
    with pytest.raises(ValueError, match="overlap"):
        tiled_upscale(lambda b: b, torch.zeros((8, 8, 3)), tile=8,
                      overlap=8)


def test_pth_roundtrip_and_find_checkpoint(weights, tmp_path):
    _, variables, pth, _ = weights
    # a .ckpt name finds the .pth beside it
    assert find_checkpoint(pth[:-len(".pth")] + ".ckpt") == pth
    assert find_checkpoint(str(tmp_path / "missing.ckpt")) is None
    assert load_checkpoint(str(tmp_path / "missing.pth")) is None
    loaded = load_checkpoint(pth, "esrgan")
    assert (loaded["epoch"], loaded["phase"]) == (3, "gan")
    want = from_jax_variables(variables)
    assert list(loaded["state"]) == list(want)
    for key, value in want.items():
        assert torch.equal(loaded["state"][key], value)
    # a DDP-prefixed, BasicSR-wrapped reference file loads the same
    wrapped = str(tmp_path / "wrapped.pth")
    torch.save({"epoch": 2, "phase": "psnr", "state": {"params_ema": {
        f"module.{k}": v for k, v in want.items()}}}, wrapped)
    again = load_checkpoint(wrapped)
    assert again["phase"] == "psnr" and list(again["state"]) == list(want)
    # a torch file under a .ckpt name is read as one
    misnamed = str(tmp_path / "misnamed.ckpt")
    os.replace(wrapped, misnamed)
    assert list(load_checkpoint(misnamed)["state"]) == list(want)


def test_jax_ckpt_loads_in_the_port(weights):
    _, variables, _, ckpt = weights
    loaded = load_checkpoint(ckpt, "esrgan")
    assert (loaded["epoch"], loaded["phase"]) == (3, "gan")
    want = from_jax_variables(variables)
    assert list(loaded["state"]) == list(want)
    for key, value in want.items():
        assert torch.equal(loaded["state"][key], value)


def test_checkpoint_of_unported_model_is_refused(weights, tmp_path):
    """An SRGAN checkpoint loads (SRGAN is ported); a model the port
    does not have is refused."""
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    want = SRGANGenerator(num_residual=1,
                          generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "srgan-gan-best.pth")
    save_checkpoint(path, 2, "srgan-gan", want.state_dict())
    loaded = load_checkpoint(path, "srgan")
    assert loaded["phase"] == "srgan-gan"
    for key, value in want.state_dict().items():
        assert torch.equal(loaded["state"][key], value), key
    with pytest.raises(RuntimeError, match="not supported"):
        load_checkpoint(weights[2], "edsr")


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    return urllib.request.urlopen(req, timeout=120)


@pytest.fixture(scope="module")
def served(weights):
    """The port's daemon on the CPU and the JAX service, same weights."""
    from torchsr_tpu.infer.server import (
        CheckpointUpscaleService as JaxService,
    )

    _, _, pth, ckpt = weights
    service = server.CheckpointUpscaleService(
        model="esrgan", checkpoint=pth, tile=16, tile_batch=2,
        device="cpu",
    )
    httpd = server.make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    jax_service = JaxService(model="esrgan", checkpoint=ckpt, tile=16,
                             tile_batch=2)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", jax_service
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def test_server_answers_like_the_jax_service(served):
    base, jax_service = served
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        assert resp.status == 200
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["backend"] == "checkpoint"
    assert health["compute_dtype"] == "float32" and health["scale"] == 4

    frame = np.random.default_rng(9).integers(0, 256, (20, 27, 3), np.uint8)
    with _post(base + "/upscale", _png(frame)) as resp:
        assert resp.headers["Content-Type"] == "image/png"
        got = np.asarray(Image.open(io.BytesIO(resp.read())))
    want = np.asarray(Image.open(io.BytesIO(
        jax_service.upscale_png(_png(frame)))))
    assert got.shape == want.shape == (80, 108, 3) and got.dtype == np.uint8
    # uint8 rounding of f32 values that agree to ~1e-7: at most 1 level
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        metrics = json.loads(resp.read())
    assert metrics["requests"] >= 1 and metrics["errors"] == 0
    assert metrics["ready"] is True
    with urllib.request.urlopen(base + "/metrics?format=prometheus",
                                timeout=30) as resp:
        text = resp.read().decode()
    assert f"torchsr_requests {metrics['requests']}" in text
    with urllib.request.urlopen(base + "/metadata", timeout=30) as resp:
        meta = json.loads(resp.read())
    assert meta["device"] == "cpu" and meta["tile"] == 16


@pytest.mark.parametrize(
    "path, body, code",
    [("/upscale", b"not an image", 400), ("/upscale", b"", 400),
     ("/nowhere", b"x", 404), ("/upscale?overlap=x", b"x", 400),
     ("/upscale?format=gif", None, 400)],
)
def test_server_rejects_bad_requests(served, path, body, code):
    base, _ = served
    if body is None:
        body = _png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + path, body)
    assert exc.value.code == code


def test_entry_points_refuse_to_fall_back_to_the_cpu(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        runner.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        server.CheckpointUpscaleService(model="esrgan",
                                        checkpoint=weights[2])
    args = argparse.Namespace(image="x.png", model="esrgan",
                              checkpoint=weights[2])
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_test(args, ESRGANGenerator)


@pytest.mark.parametrize("tile_args", [[], ["--tile", "8", "--tile-batch",
                                            "3", "--tile-overlap", "2"]])
def test_cli_test_subcommand_on_cpu(weights, tmp_path, monkeypatch,
                                    tile_args):
    monkeypatch.chdir(tmp_path)
    frame = np.random.default_rng(2).integers(0, 256, (10, 14, 3), np.uint8)
    Image.fromarray(frame).save(tmp_path / "photo.png")
    cli.main(["test", "photo.png", "--checkpoint", weights[2],
              "--device", "cpu", *tile_args])
    out = np.asarray(Image.open(tmp_path / "upres-photo.png"))
    assert out.shape == (40, 56, 3)


def test_cli_registers_only_ported_flags():
    args = cli.parse_args(["serve"])
    assert (args.device, args.tile_batch, args.port, args.tile) == (
        "cuda", 16, 8765, 0)
    args = cli.parse_args(["test", "a.png"])
    assert (args.device, args.tile_batch, args.tile_overlap) == (
        "cuda", 8, 16)
    args = cli.parse_args(["train"])
    assert (args.device, args.batch_size, args.epochs, args.pretrain_epochs,
            args.train_dir, args.model, args.seed) == (
        "cuda", 64, 1000, 1000, "dataset", "ESRGAN", 0)
    args = cli.parse_args(["train", "--eval-dir", "v",
                           "--dataset-multiplier", "16"])
    assert (args.eval_dir, args.dataset_multiplier) == ("v", 16)
    args = cli.parse_args(["eval", "val"])
    assert (args.device, args.tile, args.tile_overlap, args.tile_batch,
            args.crop, args.bf16, args.model) == (
        "cuda", 0, 16, 8, None, False, "ESRGAN")
    args = cli.parse_args(["interp", "p.pth", "g.pth"])
    assert (args.alpha, args.output, args.model) == (0.8, None, "ESRGAN")
    for argv in (["train", "--fast-compile"], ["train", "--scale", "2"],
                 ["export", "x"], ["test", "a.png", "--spatial-shard"],
                 ["serve", "--shard-tiles"], ["serve", "art.shlo"],
                 ["test", "a.png", "--tile", "8", "--tile-overlap", "8"],
                 ["eval", "val", "--artifact", "art.shlo"],
                 ["pack", "ds", "ds.tsrpack"], ["train", "--shuffle-window",
                                                "64"],
                 ["eval", "val", "--tile", "8", "--tile-overlap", "8"]):
        with pytest.raises(SystemExit):
            cli.parse_args(argv)


def test_serve_subcommand_starts_and_drains_on_sigterm(weights):
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchsr_tpu_torch", "serve",
         "--checkpoint", weights[2], "--device", "cpu", "--port", "0",
         "--tile", "16", "--tile-batch", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        line = proc.stdout.readline()
        assert "Serving esrgan checkpoint" in line, proc.stderr.read()
        url = re.search(r"http://\S+", line).group(0)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "stopped cleanly after 0 requests" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
