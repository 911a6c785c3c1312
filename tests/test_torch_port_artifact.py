"""Serving artifacts of the port (``infer/serving.py``, ``export``,
``serve ARTIFACT``, ``eval --artifact``) and the RDB operator they bake
(``ops/rdb.py`` ``torchsr_tpu_torch::rdb_fwd``), on the CPU.

An artifact is a ``torch.export`` program of the eval generator with its
weights inside.  Held here: the portable (pure aten) and the native (RDB
operator) artifact against the live generator (f32, 1e-6 of the largest
output); the port's artifact against the JAX package's
``ServedGenerator`` on the same weights carried across by
``from_jax_variables`` (1e-5); a portable artifact loaded in a fresh
interpreter that cannot import the port; a native one loaded with only
``torchsr_tpu_torch.ops`` imported; the f32 boundary of a bf16 export;
the sidecar's keys (the JAX sidecar's); platform checks; the ``export``
CLI end to end, ``serve ARTIFACT`` over HTTP and ``eval --artifact``
against ``eval --checkpoint``; the operator's schema and fake
implementation under each layout variant (``torch.library.opcheck``);
and the routing of ``fused_rdb``: the operator where no backward
follows, ``_FusedRDB`` (training, unchanged) where one does.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.infer.serving import ServedGenerator as JaxServed
from torchsr_tpu.infer.serving import (
    export_generator_artifact as jax_export,
)
from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxGenerator
from torchsr_tpu.models.torch_compat import convert_esrgan_generator
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.infer.serving import (
    ServedGenerator,
    export_generator_artifact,
    rdb_op_calls,
)
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.ops import rdb as rdb_ops
from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LIVE = 1e-6
TOL_JAX = 1e-5
JAX_SIDECAR_KEYS = {"format_version", "model", "scale", "input_shape",
                    "output_shape", "dtype", "compute_dtype", "pixel_range",
                    "platforms", "calling_convention", "native_kernels"}


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    """One set of seeded 1-RRDB ESRGAN weights as JAX variables (the JAX
    package's converter of a torch state dict) and as the port's
    generator, loaded from those variables."""
    gen = JaxGenerator(num_rrdb_blocks=1)
    seeded = ESRGANGenerator(num_rrdb_blocks=1,
                             generator=torch.Generator().manual_seed(5))
    variables = convert_esrgan_generator(seeded.state_dict())
    port = ESRGANGenerator(num_rrdb_blocks=1, device="meta")
    port.load_state_dict(from_jax_variables(variables), assign=True)
    return gen, variables, port.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """A portable and a native artifact of the port's generator at
    (2, 16, 16, 3), f32."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for kind in ("portable", "native"):
        path = str(root / f"esrgan-{kind}.pt2")
        export_generator_artifact(path, weights[2], input_hw=(16, 16),
                                  batch=2, model="esrgan",
                                  native_kernels=kind == "native")
        out[kind] = path
    return out


def _x(shape=(2, 16, 16, 3), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(
        shape).astype(np.float32))


@pytest.mark.parametrize("kind", ["portable", "native"])
def test_artifact_matches_live_generator(weights, artifacts, kind):
    served = ServedGenerator(artifacts[kind], device="cpu")
    assert served.input_shape == (2, 16, 16, 3) and served.scale == 4
    x = _x()
    with torch.inference_mode():
        want = weights[2](x)
    got = served(x)
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TOL_LIVE * float(want.abs().max()))
    calls = rdb_op_calls(torch.export.load(artifacts[kind]))
    assert calls == (3 if kind == "native" else 0)


def test_port_artifact_matches_jax_served_generator(weights, artifacts,
                                                    tmp_path):
    gen, variables, _ = weights
    path = str(tmp_path / "esrgan.shlo")
    jax_export(path, gen, variables, input_hw=(16, 16), batch=2, scale=4,
               model="esrgan", platforms=("cpu",))
    x = _x(seed=3)
    want = np.asarray(JaxServed(path)(jnp.asarray(x.numpy())))
    for kind in ("portable", "native"):
        got = ServedGenerator(artifacts[kind], device="cpu")(x).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL_JAX * np.abs(want).max())
    # a frame larger than the export shape tiles through both
    frame = np.random.default_rng(4).random((30, 21, 3)).astype(np.float32)
    want = JaxServed(path).upscale_image(frame, overlap=4)
    got = ServedGenerator(artifacts["portable"], device="cpu").upscale_image(
        frame, overlap=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_JAX)


def test_artifacts_load_without_the_model_code(weights, artifacts, tmp_path):
    """One fresh interpreter: the portable artifact loads and runs while
    the port cannot be imported at all; then, with the repository on
    ``sys.path``, the native one loads once ``torchsr_tpu_torch.ops`` is
    imported, and no model, trainer, serving or checkpoint module is."""
    x = _x(seed=1)
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import importlib.util, sys, numpy as np, torch\n"
        "x = torch.from_numpy(np.load('x.npy'))\n"
        "assert importlib.util.find_spec('torchsr_tpu_torch') is None\n"
        f"ep = torch.export.load({artifacts['portable']!r})\n"
        "np.save('portable.npy', ep.module()(x).numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('torchsr')))\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import torchsr_tpu_torch.ops\n"
        f"ep = torch.export.load({artifacts['native']!r})\n"
        "np.save('native.npy', ep.module()(x).numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('torchsr')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    portable, native = (eval(line) for line in proc.stdout.split("\n")[:2])
    assert portable == []
    assert "torchsr_tpu_torch.ops.rdb" in native
    assert not [m for m in native if m.startswith(
        ("torchsr_tpu_torch.models", "torchsr_tpu_torch.train",
         "torchsr_tpu_torch.infer", "torchsr_tpu_torch.utils"))], native
    with torch.inference_mode():
        want = weights[2](x).numpy()
    for kind in ("portable", "native"):
        np.testing.assert_allclose(np.load(tmp_path / f"{kind}.npy"), want,
                                   rtol=0,
                                   atol=TOL_LIVE * np.abs(want).max())


def test_bf16_export_keeps_the_f32_boundary(weights, tmp_path):
    gen = weights[2]
    gen.compute_dtype = torch.bfloat16
    try:
        path = str(tmp_path / "bf16.pt2")
        export_generator_artifact(path, gen, input_hw=(16, 16), batch=2)
        x = _x(seed=5)
        with torch.inference_mode():
            want = gen(x)
    finally:
        gen.compute_dtype = None
    program = torch.export.load(path)
    casts = [n.args[1] for n in program.graph.nodes
             if n.op == "call_function" and "to.dtype" in str(n.target)]
    assert torch.bfloat16 in casts and torch.float32 in casts
    got = ServedGenerator(path, device="cpu")(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with open(path + ".json") as fh:
        meta = json.load(fh)
    assert meta["compute_dtype"] == "bfloat16" and meta["dtype"] == "float32"


def test_sidecar_keys_are_the_jax_sidecar_keys(artifacts):
    for kind, path in artifacts.items():
        with open(path + ".json") as fh:
            meta = json.load(fh)
        assert set(meta) == JAX_SIDECAR_KEYS
        assert meta["native_kernels"] is (kind == "native")
        assert meta["platforms"] == ["cuda", "cpu"]
        assert meta["input_shape"] == [2, 16, 16, 3]
        assert meta["output_shape"] == [2, 64, 64, 3]
        assert meta["calling_convention"] == "sr = f(lr_batch)"


def test_platform_checks(weights, tmp_path):
    path = str(tmp_path / "cuda-only.pt2")
    export_generator_artifact(path, weights[2], input_hw=(16, 16), batch=1,
                              platforms=("cuda",), native_kernels=True)
    with pytest.raises(RuntimeError, match="exported for platform"):
        ServedGenerator(path, device="cpu")
    with pytest.raises(ValueError, match="TPU artifacts"):
        export_generator_artifact(path, weights[2], input_hw=(16, 16),
                                  platforms=("tpu", "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ServedGenerator(path)  # the default device is cuda


def test_native_export_refuses_a_model_without_rdb(tmp_path):
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    gen = SRGANGenerator(num_residual=1)
    with pytest.raises(ValueError, match="ESRGAN"):
        export_generator_artifact(str(tmp_path / "s.pt2"), gen,
                                  input_hw=(16, 16), native_kernels=True)


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """The ``export`` CLI on a .pth of the weights, portable and native,
    tile 16, tile batch 2."""
    root = tmp_path_factory.mktemp("cli_export")
    pth = str(root / "esrgan-gan-best.pth")
    save_checkpoint(pth, 2, "gan", weights[2].state_dict())
    out = {"pth": pth, "root": root}
    for kind, extra in (("portable", []), ("native", ["--native-kernels"])):
        out[kind] = str(root / f"{kind}.pt2")
        cli.main(["export", out[kind], "--checkpoint", pth, "--tile", "16",
                  "--tile-batch", "2", "--device", "cpu", *extra])
    return out


def test_export_cli_roundtrip(weights, exported):
    from torchsr_tpu_torch.infer.tiled import tiled_upscale

    frame = (np.random.default_rng(6).random((23, 37, 3)) * 255).astype(
        np.uint8)
    x = torch.from_numpy(frame.astype(np.float32) / 255.0)
    with torch.inference_mode():
        want = tiled_upscale(weights[2], x, scale=4, tile=16, overlap=4,
                             tile_batch=2).clamp(0, 1).numpy()
    for kind in ("portable", "native"):
        served = ServedGenerator(exported[kind], device="cpu")
        assert served.meta["native_kernels"] is (kind == "native")
        assert served.meta["compute_dtype"] == "float32"
        got = served.upscale_image(frame, overlap=4)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LIVE)
        u8 = served.upscale_image(frame, overlap=4, quantize_u8=True)
        assert u8.dtype == np.uint8 and u8.shape == (92, 148, 3)
    with pytest.raises(ValueError, match="ESRGAN"):
        cli.main(["export", str(exported["root"] / "s.pt2"), "--model",
                  "srgan", "--native-kernels", "--device", "cpu"])
    if not torch.cuda.is_available():
        # the entry points run on the card unless asked for the CPU
        from torchsr_tpu_torch.infer.server import UpscaleService

        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(["export", str(exported["root"] / "c.pt2"),
                      "--checkpoint", exported["pth"]])
        with pytest.raises(RuntimeError, match="is_available"):
            UpscaleService(exported["portable"])


def test_serve_artifact_over_http(exported):
    from torchsr_tpu_torch.infer.server import UpscaleService, make_server

    service = UpscaleService(exported["native"], device="cpu")
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    frame = (np.random.default_rng(8).random((20, 30, 3)) * 255).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        req = urllib.request.Request(base + "/upscale", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            sr = np.asarray(Image.open(io.BytesIO(resp.read())))
        with urllib.request.urlopen(base + "/metadata", timeout=30) as resp:
            meta = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert health["status"] == "ok" and health["backend"] == "artifact"
    assert health["input_shape"] == [2, 16, 16, 3]
    assert meta["native_kernels"] is True and meta["device"] == "cpu"
    want = service.generator.upscale_image(frame, quantize_u8=True)
    np.testing.assert_array_equal(sr, want)


def test_eval_artifact_against_eval_checkpoint(exported, tmp_path):
    val = tmp_path / "val"
    val.mkdir()
    rng = np.random.default_rng(9)
    # LR 20 x 25 and 18 x 22: above the 16 px tile, so both paths tile
    for i, hw in enumerate(((80, 100), (72, 88))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(
            val / f"img{i}.png")
    reports = {}
    for name, src in (("artifact", ["--artifact", exported["portable"]]),
                      ("checkpoint", ["--checkpoint", exported["pth"],
                                      "--tile", "16", "--tile-overlap",
                                      "4", "--tile-batch", "2"])):
        report = str(tmp_path / f"{name}.json")
        cli.main(["eval", str(val), *src, "--tile-overlap", "4",
                  "--device", "cpu", "--report", report])
        with open(report) as fh:
            reports[name] = json.load(fh)
    for a, b in zip(reports["artifact"]["per_image"],
                    reports["checkpoint"]["per_image"]):
        assert a["image"] == b["image"]
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4
        assert a["bicubic_psnr"] == b["bicubic_psnr"]


def test_cli_export_serve_eval_flags():
    args = cli.parse_args(["export", "a.pt2"])
    assert (args.tile, args.tile_batch, args.platforms, args.device,
            args.bf16, args.native_kernels, args.model) == (
        64, 8, "cuda,cpu", "cuda", False, False, "ESRGAN")
    args = cli.parse_args(["serve", "a.pt2"])
    assert (args.artifact, args.batch_requests, args.batch_wait_ms) == (
        "a.pt2", False, 2.0)
    assert cli.parse_args(["eval", "val", "--artifact", "a.pt2"]).artifact \
        == "a.pt2"
    for argv in (["eval", "val", "--artifact", "a.pt2", "--bf16"],
                 ["serve", "a.pt2", "--checkpoint", "c.pth"],
                 ["serve", "a.pt2", "--batch-requests"],
                 ["export", "a.pt2", "--tile", "0"]):
        with pytest.raises(SystemExit):
            cli.parse_args(argv)


def _block(seed=0, shape=(2, 5, 16, 64)):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 0.5
    ks = [torch.randn((3, 3, ci, co), generator=gen) * 0.05
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    bs = [torch.randn((co,), generator=gen) * 0.1 for co in rdb_ops.COUT]
    return x, ks, bs


@pytest.mark.parametrize("variant", ["slot", "ext", "ilv"])
def test_rdb_operator_schema_fake_and_value(variant):
    x, ks, bs = _block()
    torch.library.opcheck(torch.ops.torchsr_tpu_torch.rdb_fwd.default,
                          (x, ks, bs, 0.2, variant),
                          test_utils=("test_schema", "test_faketensor"))
    got = torch.ops.torchsr_tpu_torch.rdb_fwd(x, ks, bs, 0.2, variant)
    want = rdb_ops.rdb_reference(x, ks, bs, scale_ratio=0.2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fused_rdb_routes_inference_to_the_operator():
    x, ks, bs = _block(1)
    calls = []
    op = torch.ops.torchsr_tpu_torch.rdb_fwd

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append(func)
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Spy():
        rdb_ops.fused_rdb(x, ks, bs)
    assert op.default in calls
    ks = [k.requires_grad_() for k in ks]
    out = rdb_ops.fused_rdb(x, ks, bs)
    assert type(out.grad_fn).__name__ == "_FusedRDBBackward"
    with rdb_ops.plain_forward(), torch.no_grad():
        calls.clear()
        with Spy():
            rdb_ops.fused_rdb(x, ks, bs)
        assert op.default not in calls


@pytest.mark.parametrize("backend", ["artifact", "batched_checkpoint"])
def test_serve_subcommand_backends(exported, backend):
    """``serve ARTIFACT`` and ``serve --batch-requests`` as processes:
    ready, one request answered 4x, a clean drain on SIGTERM."""
    import re
    import signal

    source = ([exported["native"]] if backend == "artifact" else
              ["--checkpoint", exported["pth"], "--tile", "16",
               "--tile-batch", "2", "--batch-requests",
               "--batch-wait-ms", "5"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchsr_tpu_torch", "serve", *source,
         "--device", "cpu", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        what = "artifact" if backend == "artifact" else "checkpoint"
        assert f"Serving esrgan {what}" in line, proc.stderr.read()
        url = re.search(r"http://\S+", line).group(0)
        buf = io.BytesIO()
        Image.fromarray(np.zeros((12, 10, 3), np.uint8)).save(buf, "PNG")
        req = urllib.request.Request(url + "/upscale", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            sr = np.asarray(Image.open(io.BytesIO(resp.read())))
        assert sr.shape == (48, 40, 3)
        with urllib.request.urlopen(url + "/metadata", timeout=30) as resp:
            meta = json.loads(resp.read())
        assert meta["backend"] == what
        assert meta.get("batch_requests", False) is (backend != "artifact")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "stopped cleanly after 1 requests" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
