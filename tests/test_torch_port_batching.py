"""Cross-request dynamic tile batching in the port (``infer/batching.py``,
``serve --batch-requests``) against the JAX package's.

The cases of the JAX package's ``tests/test_batching.py`` (its sharded
ones excepted: the card's machine has one device): the batcher
coalesces tiles of concurrent submissions into shared fixed-shape
forwards and splits big jobs across them, exactly; errors reach the
callers and the worker survives; the host extract and composite mirror
the device path; and the HTTP daemon with batching on answers concurrent
small frames with the pixels of the daemon without it.  The port's
``extract_tiles``, ``count_tiles`` and ``composite_tiles`` are also held
against the JAX package's on the same arrays (equal to the last bit: the
same numpy operations).  Everything runs on the CPU in f32.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.infer import batching as jax_batching
from torchsr_tpu_torch.infer.batching import (
    TileBatcher,
    composite_tiles,
    count_tiles,
    extract_tiles,
)
from torchsr_tpu_torch.infer.tiled import tiled_upscale
from torchsr_tpu_torch.models.srgan import SRGANGenerator

TILE = 8
SCALE = 4


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


def _nearest4x(batch: np.ndarray) -> np.ndarray:
    """Exact, deterministic stand-in for the generator forward."""
    return batch.repeat(SCALE, axis=1).repeat(SCALE, axis=2)


def _tiles(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n, TILE, TILE, 3)).astype(np.float32)


def _make_batcher(batch=4, wait=50.0, calls=None):
    def forward(x):
        if calls is not None:
            calls.append(x.shape[0])
        return _nearest4x(x)

    return TileBatcher(forward, tile=TILE, scale=SCALE, batch=batch,
                       max_wait_ms=wait)


def test_single_job_exact_and_split_across_calls():
    """5 tiles through batch=2: three forwards, results in order."""
    calls = []
    b = _make_batcher(batch=2, wait=0.0, calls=calls)
    try:
        tiles = _tiles(5, seed=1)
        np.testing.assert_array_equal(b.upscale_tiles(tiles),
                                      _nearest4x(tiles))
        s = b.stats()
        assert s["batched_tiles"] == 5 and s["batched_calls"] == 3
        assert calls == [2, 2, 2]  # the last one padded
    finally:
        b.close()


def test_concurrent_submissions_coalesce():
    """8 one-tile requests from 8 threads share device calls."""
    calls = []
    b = _make_batcher(batch=4, wait=200.0, calls=calls)
    barrier = threading.Barrier(8)
    results: dict = {}

    def client(i):
        tiles = _tiles(1, seed=i)
        barrier.wait()
        results[i] = (tiles, b.upscale_tiles(tiles))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(8):
            tiles, out = results[i]
            np.testing.assert_array_equal(out, _nearest4x(tiles))
        assert len(calls) < 8
        assert b.stats()["batched_tiles"] == 8
    finally:
        b.close()


def test_empty_and_bad_shapes():
    b = _make_batcher()
    try:
        out = b.upscale_tiles(np.empty((0, TILE, TILE, 3), np.float32))
        assert out.shape == (0, TILE * SCALE, TILE * SCALE, 3)
        with pytest.raises(ValueError, match="expected"):
            b.upscale_tiles(np.zeros((1, TILE + 1, TILE, 3), np.float32))
    finally:
        b.close()
    with pytest.raises(ValueError, match="batch must be"):
        TileBatcher(_nearest4x, tile=TILE, scale=SCALE, batch=0)


def test_forward_error_propagates_and_close_rejects():
    def boom(x):
        raise RuntimeError("device on fire")

    b = TileBatcher(boom, tile=TILE, scale=SCALE, batch=2, max_wait_ms=0)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            b.upscale_tiles(_tiles(3))
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.upscale_tiles(_tiles(1))


def test_wrong_forward_shape_fails_caller_not_worker():
    """A misbehaving forward fails the waiting request; the worker
    survives to serve the next one."""
    bad = {"on": True}

    def forward(x):
        return x if bad["on"] else _nearest4x(x)

    b = TileBatcher(forward, tile=TILE, scale=SCALE, batch=2, max_wait_ms=0)
    try:
        with pytest.raises(ValueError, match="forward returned"):
            b.upscale_tiles(_tiles(1))
        bad["on"] = False
        tiles = _tiles(2, seed=9)
        np.testing.assert_array_equal(b.upscale_tiles(tiles),
                                      _nearest4x(tiles))
    finally:
        b.close()


@pytest.mark.parametrize("h, w, tile, ov", [
    (5, 9, 8, 2), (8, 8, 8, 0), (30, 17, 8, 3), (64, 64, 16, 8)])
def test_count_tiles_matches_extraction_and_jax(h, w, tile, ov):
    img = np.random.default_rng(0).random((h, w, 3)).astype(np.float32)
    tiles, grid, padded = extract_tiles(img, tile, ov)
    assert count_tiles(h, w, tile, ov) == len(grid) == tiles.shape[0]
    j_tiles, j_grid, j_padded = jax_batching.extract_tiles(img, tile, ov)
    np.testing.assert_array_equal(tiles, j_tiles)
    assert (grid, padded) == (j_grid, j_padded)
    assert count_tiles(h, w, tile, ov) == jax_batching.count_tiles(h, w,
                                                                   tile, ov)


@pytest.mark.parametrize("hw, tile, ov", [
    ((40, 26), 16, 4), ((10, 13), 16, 4), ((37, 50), 16, 10)])
def test_composite_equals_jax_composite(hw, tile, ov):
    img = np.random.default_rng(sum(hw)).random((*hw, 3)).astype(np.float32)
    tiles, grid, padded = extract_tiles(img, tile, ov)
    sr = _nearest4x(tiles) ** 2
    got = composite_tiles(sr, grid, padded, hw, tile, ov, SCALE)
    want = jax_batching.composite_tiles(sr, grid, padded, hw, tile, ov,
                                        SCALE)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def srgan():
    gen = SRGANGenerator(num_residual=1,
                         generator=torch.Generator().manual_seed(11))
    return gen.eval().requires_grad_(False)


@pytest.mark.parametrize("hw", [(40, 26), (10, 13)],
                         ids=["tiled", "sub_tile"])
def test_host_composite_matches_device_tiled_path(srgan, hw):
    """extract -> forward -> composite on the host reproduces
    ``tiled_upscale``'s device path for a tiny SRGAN generator (the
    same f32 sums in the same order; the forward runs other batch sizes
    there, whose convolutions may round apart: 1e-5 of the largest
    value, measured 1.4e-6)."""
    img = np.random.default_rng(2).random((*hw, 3)).astype(np.float32)
    tile, overlap = 16, 4
    with torch.inference_mode():
        ref = tiled_upscale(srgan, torch.from_numpy(img), scale=4,
                            tile=tile, overlap=overlap,
                            tile_batch=4).numpy()
        tiles, grid, padded = extract_tiles(img, tile, overlap)
        sr = srgan(torch.from_numpy(tiles)).numpy()
    out = composite_tiles(sr, grid, padded, img.shape[:2], tile, overlap, 4)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# --------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def batching_servers(tmp_path_factory, srgan):
    """Two checkpoint-backed daemons off one tiny SRGAN checkpoint,
    dynamic batching on and off, on the CPU."""
    from torchsr_tpu_torch.infer.server import (
        CheckpointUpscaleService,
        make_server,
    )
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("batch_server")
    path = str(root / "srgan-gan-best.pth")
    save_checkpoint(path, 1, "gan", srgan.state_dict())
    servers, bases = [], {}
    for name, batching in (("on", True), ("off", False)):
        service = CheckpointUpscaleService(
            model="srgan", checkpoint=path, tile=16, tile_batch=4,
            batch_requests=batching, batch_wait_ms=100.0, device="cpu")
        server = make_server(service, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        bases[name] = f"http://127.0.0.1:{server.server_address[1]}"
    yield bases
    for server in servers:
        server.shutdown()
        server.server_close()
        server.service.close()


def _post_png(base: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    req = urllib.request.Request(base + "/upscale", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return np.asarray(Image.open(io.BytesIO(resp.read())))


def _metrics(base: str) -> dict:
    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        return json.loads(resp.read())


def test_server_batched_equals_unbatched(batching_servers):
    """Concurrent small frames through the batched daemon: each answer
    within one uint8 level of the unbatched daemon's (the host composite
    and the device blend sum alike; rounding ties may differ)."""
    seeds_sizes = [(i, 10 + i, 12 + 2 * i) for i in range(6)]
    ref = {s: _post_png(batching_servers["off"], h, w, s)
           for s, h, w in seeds_sizes}
    results: dict = {}
    barrier = threading.Barrier(len(seeds_sizes))

    def client(seed, h, w):
        barrier.wait()
        results[seed] = _post_png(batching_servers["on"], h, w, seed)

    threads = [threading.Thread(target=client, args=args)
               for args in seeds_sizes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for seed, h, w in seeds_sizes:
        assert results[seed].shape == (h * 4, w * 4, 3)
        diff = np.abs(results[seed].astype(np.int32)
                      - ref[seed].astype(np.int32))
        assert diff.max() <= 1
    m = _metrics(batching_servers["on"])
    # warmup (1 tile) + 6 one-tile requests, batch 4, 100 ms fill wait
    assert m["batched_tiles"] >= 7
    assert m["batched_calls"] < m["batched_tiles"]
    assert m["batch_fill_mean"] is not None


def test_server_big_frame_bypasses_batcher(batching_servers):
    """A frame that fills the tile batch alone keeps the on-device
    tiled path: batched_tiles does not grow."""
    before = _metrics(batching_servers["on"])["batched_tiles"]
    # 40x40 at tile 16 / overlap 8 -> 16 tiles >= tile_batch (4)
    assert _post_png(batching_servers["on"], 40, 40, 99).shape == (160, 160,
                                                                   3)
    assert _metrics(batching_servers["on"])["batched_tiles"] == before


def test_batched_forwards_are_timed_as_device_calls(tmp_path, srgan):
    """The batcher's worker takes the device lock for each forward: its
    wait and hold count in lock_wait_ms_mean and device_ms_mean."""
    from torchsr_tpu_torch.infer.server import CheckpointUpscaleService
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    path = str(tmp_path / "srgan-gan-best.pth")
    save_checkpoint(path, 1, "gan", srgan.state_dict())
    service = CheckpointUpscaleService(
        model="srgan", checkpoint=path, tile=16, tile_batch=4,
        batch_requests=True, batch_wait_ms=1.0, device="cpu")
    try:
        frame = np.zeros((12, 14, 3), np.uint8)  # one tile: batched
        for _ in range(2):
            assert service._guarded_upscale(frame, None).shape == (48, 56, 3)
        m = service.metrics()
    finally:
        service.close()
    assert m["batched_calls"] >= 2
    assert service._device_calls == m["batched_calls"]
    assert m["device_ms_mean"] > 0 and m["lock_wait_ms_mean"] >= 0


def test_batched_meta_metrics_and_cli_flags(batching_servers):
    with urllib.request.urlopen(batching_servers["on"] + "/metadata",
                                timeout=30) as resp:
        assert json.loads(resp.read())["batch_requests"] is True
    with urllib.request.urlopen(batching_servers["off"] + "/metadata",
                                timeout=30) as resp:
        assert json.loads(resp.read())["batch_requests"] is False
    req = urllib.request.Request(
        batching_servers["on"] + "/metrics?format=prometheus")
    with urllib.request.urlopen(req, timeout=30) as resp:
        text = resp.read().decode()
    assert "# TYPE torchsr_batched_calls counter" in text
    assert "torchsr_batch_fill_mean" in text
    from torchsr_tpu_torch.cli import parse_args

    args = parse_args(["serve", "--batch-requests", "--batch-wait-ms", "5"])
    assert args.batch_requests is True and args.batch_wait_ms == 5.0
    assert parse_args(["serve"]).batch_wait_ms == 2.0
