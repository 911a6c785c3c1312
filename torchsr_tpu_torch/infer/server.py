"""``serve``: an HTTP daemon around a trained ESRGAN or SRGAN generator.

The PyTorch counterpart of the JAX package's serving daemon, on the
standard library's ``http.server``, with its two backends:

- **checkpoint** (``serve --checkpoint x --model esrgan``): the
  checkpoint loaded into the live generator on the CUDA device (bf16
  compute unless ``--disable-amp``; SRGAN's BatchNorms on their running
  statistics); every frame is tiled through it on the device, each tile
  batch one replay of the generator's captured CUDA graph
  (``infer/tiled.py``).  ``batch_requests`` routes frames that tile to
  fewer than ``tile_batch`` tiles through a shared ``TileBatcher``
  (``infer/batching.py``), whose forward replays the same graph.
- **artifact** (``serve model.pt2``): a serving artifact of
  ``infer/serving.py``, loaded with ``torch.export.load``; its tile
  batches replay a graph of the loaded program.

Endpoints:

- ``GET /healthz``: 200 once the warmup forward has run, 503 before.
- ``GET /metadata``: the serving configuration as JSON.
- ``GET /metrics``: request counters, the time device calls held and
  waited for the device lock, the process's tiling and CUDA graph
  counters, the model kernels' launch counters (``ops.launch_counts``,
  replays counted), JSON (or Prometheus text with ``?format=prometheus`` or
  ``Accept: text/plain``).
- ``POST /upscale``: an encoded image in (anything Pillow decodes); the
  super-resolved image out, PNG by default, ``?format=jpeg|webp`` with
  ``&quality=N``, ``?compress=N`` (PNG zlib level), ``?overlap=N``
  (tiling halo in LR pixels).

Admission: request bodies above ``max_request_mb`` and decoded inputs
above ``max_input_mp`` get 413; beyond ``max_pending`` upscales in
flight new ones get 503 with Retry-After.  A ``ThreadingHTTPServer``
keeps decode and encode off the device path, and one lock serializes
the device calls.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from torchsr_tpu_torch.utils import trace

_FORMATS = {
    "png": "PNG", "jpeg": "JPEG", "jpg": "JPEG", "webp": "WEBP",
}


class RequestTooLarge(ValueError):
    """Request exceeds an admission limit — mapped to HTTP 413."""


class _Service:
    """Transport-agnostic core: decode -> locked device call -> encode.
    Subclasses implement ``_upscale(uint8 HWC) -> uint8 HWC`` and
    ``warmup()``, and populate ``meta``."""

    def __init__(
        self,
        overlap: int | None = None,
        max_request_mb: float = 64,
        max_input_mp: float = 32,
        max_pending: int = 8,
    ):
        self.overlap = overlap
        # Admission limits (0 disables): body bytes bound what a request
        # makes the host allocate, decoded megapixels what it makes the
        # device compute.
        self.max_request_bytes = int(max_request_mb * 1e6)
        self.max_input_pixels = int(max_input_mp * 1e6)
        # Load shedding: device calls serialize behind _lock, so beyond
        # max_pending in-flight upscales new ones get 503 + Retry-After
        # instead of an unbounded queue.  0 = unbounded.
        self.max_pending = int(max_pending)
        self._in_flight = 0
        self._shed = 0
        self._admission_lock = threading.Lock()
        self._lock = threading.Lock()
        self.ready = False
        self.meta: dict = {}
        # counters for GET /metrics, under their own lock so a slow
        # device call never blocks a scrape
        self._stats_lock = threading.Lock()
        self._started = time.time()
        self._requests = 0
        self._errors = 0
        self._total_ms = 0.0
        self._last_ms = 0.0
        # device calls made under _lock (a frame's tiled forward, or a
        # batcher's forward): their time holding it, and the time they
        # waited for it (the service's queue)
        self._device_calls = 0
        self._device_ms = 0.0
        self._lock_wait_ms = 0.0

    def metrics(self) -> dict:
        """Counters since startup: request/error totals, mean and last
        wall latency, the mean time a device call held and waited for
        the device lock, uptime; and the process's tiling, CUDA graph
        and kernel build counters (``utils/trace.py``), and the model
        kernels' counters (``ops.launch_counts``) by lower-case name."""
        from torchsr_tpu_torch.ops import launch_counts

        counts = trace.counters()
        slot_px = counts.get("tile_slot_px", 0)
        with self._stats_lock:
            n, calls = self._requests, self._device_calls
            with self._admission_lock:
                in_flight, shed = self._in_flight, self._shed
            return {
                "ready": self.ready,
                "uptime_s": round(time.time() - self._started, 1),
                "requests": n,
                "errors": self._errors,
                "in_flight": in_flight,
                "shed": shed,
                "latency_ms_mean": round(self._total_ms / n, 1) if n else None,
                "latency_ms_last": round(self._last_ms, 1) if n else None,
                "device_ms_mean":
                    round(self._device_ms / calls, 1) if calls else None,
                "lock_wait_ms_mean":
                    round(self._lock_wait_ms / calls, 3) if calls else None,
                "tiles": counts.get("tiles", 0),
                "tile_slots": counts.get("tile_slots", 0),
                "tile_useful_pct": round(
                    100.0 * counts.get("tile_lr_px", 0) / slot_px, 2)
                if slot_px else None,
                "graph_captures": counts.get("graph_captures", 0),
                "graph_replays": counts.get("graph_replays", 0),
                "kernel_builds": counts.get("kernel_builds", 0),
                **{k.lower(): v for k, v in launch_counts().items()},
            }

    def admit(self) -> bool:
        """Reserve an upscale slot; False = shed this request (503)."""
        with self._admission_lock:
            if self.max_pending and self._in_flight >= self.max_pending:
                self._shed += 1
                return False
            self._in_flight += 1
            return True

    def release(self) -> None:
        with self._admission_lock:
            self._in_flight -= 1

    def _upscale(self, arr: np.ndarray, overlap: int | None) -> np.ndarray:
        raise NotImplementedError

    @contextlib.contextmanager
    def _device_lock(self):
        """Hold the device lock for one device call, timing the wait for
        it and the hold."""
        t0 = time.perf_counter()
        with self._lock:
            t1 = time.perf_counter()
            yield
            t2 = time.perf_counter()
        with self._stats_lock:
            self._device_calls += 1
            self._lock_wait_ms += (t1 - t0) * 1e3
            self._device_ms += (t2 - t1) * 1e3

    def _guarded_upscale(self, arr: np.ndarray,
                         overlap: int | None) -> np.ndarray:
        """Device-access policy around ``_upscale``: one forward at a
        time.  The batching backend routes small frames elsewhere."""
        with self._device_lock():
            return self._upscale(arr, overlap)

    def warmup(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release backend resources (worker threads); idempotent."""

    def upscale_bytes(
        self,
        body: bytes,
        overlap: int | None = None,
        fmt: str = "png",
        quality: int = 92,
        compress: int = 6,
    ) -> tuple[bytes, str]:
        """Decode ``body``, super-resolve, encode; returns
        ``(payload, content_type)``."""
        from PIL import Image

        t0 = time.perf_counter()
        try:
            pil_fmt = _FORMATS.get(fmt.lower())
            if pil_fmt is None:
                raise ValueError(
                    f"unsupported format {fmt!r} (use png, jpeg, or "
                    f"webp)"
                )
            img = Image.open(io.BytesIO(body))
            # the size comes from the header: check before .convert()
            # decodes the whole image
            if (
                self.max_input_pixels
                and img.width * img.height > self.max_input_pixels
            ):
                raise RequestTooLarge(
                    f"input is {img.width}x{img.height} "
                    f"({img.width * img.height / 1e6:.1f} MP); this "
                    f"server caps inputs at "
                    f"{self.max_input_pixels / 1e6:g} MP"
                )
            arr = np.asarray(img.convert("RGB"), np.uint8)
            sr = self._guarded_upscale(
                arr, overlap if overlap is not None else self.overlap
            )
            out = Image.fromarray(np.asarray(sr, np.uint8))
            buf = io.BytesIO()
            if pil_fmt == "PNG":
                level = min(max(int(compress), 0), 9)
                out.save(buf, format="PNG", compress_level=level)
            else:
                out.save(buf, format=pil_fmt, quality=int(quality))
            ctype = f"image/{pil_fmt.lower()}"
        except Exception:
            with self._stats_lock:
                self._errors += 1
            raise
        with self._stats_lock:
            self._requests += 1
            self._last_ms = (time.perf_counter() - t0) * 1e3
            self._total_ms += self._last_ms
        return buf.getvalue(), ctype


class UpscaleService(_Service):
    """Artifact-backed service around a serving artifact
    (``infer/serving.py``) on ``device``."""

    def __init__(self, artifact_path: str, overlap: int | None = None,
                 device: str | torch.device = "cuda", **limits):
        from torchsr_tpu_torch.infer.serving import ServedGenerator

        super().__init__(overlap, **limits)
        self.generator = ServedGenerator(artifact_path, device=device)
        self.device = self.generator.device
        self.meta = {"backend": "artifact", **self.generator.meta,
                     "device": _device_name(self.device)}

    def warmup(self) -> None:
        """One forward at the export shape, so the graph is captured
        (and the kernels loaded) before the first request."""
        x = torch.zeros(self.generator.input_shape, device=self.device)
        with self._lock:
            self.generator(x).cpu()
        self.ready = True

    def _upscale(self, arr: np.ndarray, overlap: int | None) -> np.ndarray:
        return self.generator.upscale_image(arr, overlap=overlap,
                                            quantize_u8=True)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


class CheckpointUpscaleService(_Service):
    """Checkpoint-backed service: the live generator on ``device``
    (``"cuda"`` by default; ``"cpu"`` only when asked for), frames
    tiled through it on the device (each tile batch a replay of its
    captured graph on CUDA) and rounded to uint8 there.

    ``batch_requests=True`` turns on cross-request dynamic batching
    (``infer/batching.py``): a frame that tiles to fewer than
    ``tile_batch`` tiles goes through a shared ``TileBatcher``, so
    concurrent small frames fill one device batch together; frames that
    fill a batch alone keep the on-device tiled path.

    ``shard_devices`` (``--shard-tiles``): each frame's tile batches
    spread over these devices, a generator replica on each
    (``infer/multichip.py``); the frame's tiles and blend stay on
    ``device``."""

    def __init__(
        self,
        model: str,
        checkpoint: str | None = None,
        tile: int = 0,
        tile_batch: int = 16,
        overlap: int | None = None,
        disable_amp: bool = False,
        device: str | torch.device = "cuda",
        batch_requests: bool = False,
        batch_wait_ms: float = 2.0,
        shard_devices: list | None = None,
        **limits,
    ):
        from argparse import Namespace

        from torchsr_tpu_torch.infer.runner import (
            load_trained_generator,
            resolve_compute_dtype,
            resolve_device,
        )
        from torchsr_tpu_torch.infer.tiled import (
            DEFAULT_SERVING_TILE,
            tile_forward,
        )
        from torchsr_tpu_torch.registry import select_test_model

        super().__init__(overlap, **limits)
        self.device = resolve_device(device)
        model = model.lower()
        args = Namespace(model=model, checkpoint=checkpoint,
                         disable_amp=disable_amp)
        dtype = resolve_compute_dtype(args, self.device)
        self._generator = load_trained_generator(
            args, select_test_model(args), device=self.device,
            compute_dtype=dtype,
        )
        self._forward = tile_forward(self._generator, self.device)
        self._shard = None
        if shard_devices:
            from torchsr_tpu_torch.infer.multichip import sharded_forwards

            self._shard = (list(shard_devices), sharded_forwards(
                self._generator, list(shard_devices)))
        self.tile = int(tile) or DEFAULT_SERVING_TILE.get(model, 64)
        self.tile_batch = int(tile_batch)
        self.scale = int(self._generator.scale_factor)
        self._batcher = None
        if batch_requests:
            from torchsr_tpu_torch.infer.batching import TileBatcher

            self._batcher = TileBatcher(
                self._batch_forward, tile=self.tile, scale=self.scale,
                batch=self.tile_batch, max_wait_ms=batch_wait_ms,
            )
        self.meta = {
            "backend": "checkpoint",
            "model": model,
            "checkpoint": checkpoint or f"{model}-gan-best",
            "scale": self.scale,
            "tile": self.tile,
            "tile_batch": self.tile_batch,
            "compute_dtype": str(dtype).removeprefix("torch."),
            "device": _device_name(self.device),
            "batch_requests": self._batcher is not None,
            "shard_devices": len(self._shard[0]) if self._shard else 0,
        }

    def warmup(self) -> None:
        """One tiled forward on a dummy frame slightly above the tile
        size, so the first request finds the kernels built and loaded
        and the tile batch's graph captured (with batching on, the
        batcher's forward replays that graph once too)."""
        dummy = np.zeros((self.tile + 8, self.tile + 8, 3), np.uint8)
        with self._lock:
            self._upscale(dummy, self.overlap)
        if self._batcher is not None:
            tiny = np.zeros((self.tile, self.tile, 3), np.uint8)
            self._upscale_batched(tiny, self._resolve_overlap(None))
        self.ready = True

    def _resolve_overlap(self, overlap: int | None) -> int:
        if overlap is None:
            overlap = 8
        return max(0, min(int(overlap), self.tile - 1))

    def _batch_forward(self, batch: np.ndarray) -> np.ndarray:
        """The batcher's device call: the graphed tile forward, under
        the service lock (taken here, by the batcher's worker, so that
        request threads never hold it while they wait on their tiles)."""
        with self._device_lock(), torch.inference_mode():
            x = torch.from_numpy(batch).to(self.device)
            return self._forward(x).float().cpu().numpy()

    def _guarded_upscale(self, arr: np.ndarray,
                         overlap: int | None) -> np.ndarray:
        """Small frames through the shared tile batcher; frames that
        fill a device batch alone keep the on-device tiled path."""
        if self._batcher is not None:
            from torchsr_tpu_torch.infer.batching import count_tiles

            ov = self._resolve_overlap(overlap)
            h, w = arr.shape[:2]
            if count_tiles(h, w, self.tile, ov) < self.tile_batch:
                return self._upscale_batched(arr, ov)
        with self._device_lock():
            return self._upscale(arr, overlap)

    def _upscale_batched(self, arr: np.ndarray, overlap: int) -> np.ndarray:
        """Host extract -> shared batched device forward -> host
        composite (the numpy mirror of the device blend)."""
        from torchsr_tpu_torch.infer.batching import (
            composite_tiles,
            extract_tiles,
        )

        x = np.asarray(arr, np.float32) / np.float32(255.0)
        tiles, grid, padded = extract_tiles(x, self.tile, overlap)
        sr = self._batcher.upscale_tiles(tiles)
        out = composite_tiles(sr, grid, padded, x.shape[:2], self.tile,
                              overlap, self.scale)
        return (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    def metrics(self) -> dict:
        m = super().metrics()
        if self._batcher is not None:
            m.update(self._batcher.stats())
        return m

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()

    def _upscale(self, arr: np.ndarray, overlap: int | None) -> np.ndarray:
        from torchsr_tpu_torch.infer.multichip import tiled_upscale_sharded
        from torchsr_tpu_torch.infer.tiled import tiled_upscale

        h, w = arr.shape[:2]
        with trace.span("serve.request", lr_h=h, lr_w=w):
            with trace.span("serve.upload"):
                x = torch.tensor(arr, device=self.device).float() / 255.0
            kw = {"scale": self.scale, "tile": self.tile,
                  "overlap": self._resolve_overlap(overlap),
                  "tile_batch": self.tile_batch}
            with trace.span("serve.tiles"):
                if self._shard is not None:
                    devices, forwards = self._shard
                    out = tiled_upscale_sharded(forwards, x, devices, **kw)
                else:
                    out = tiled_upscale(self._forward, x, **kw)
            # round to uint8 on the device: the host copy moves 4x fewer
            # bytes than the f32 frame
            u8 = (out.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
            with trace.span("serve.copy_out", device=self.device):
                u8 = u8.cpu()
        return u8.numpy()


_PROM_HELP = {
    "ready": "1 once the warmup forward has completed",
    "uptime_s": "seconds since service start",
    "requests": "total upscale requests served",
    "errors": "total failed upscale requests",
    "in_flight": "upscales currently queued or executing",
    "shed": "requests rejected 503 by load shedding",
    "latency_ms_mean": "mean request wall latency",
    "latency_ms_last": "last request wall latency",
    "device_ms_mean": "mean time a device call held the device lock",
    "lock_wait_ms_mean": "mean time a device call waited for the device "
                         "lock (the service's queue)",
    "tiles": "tiles cut on the device from frames by this process "
             "(frames through the batcher count in batched_tiles)",
    "tile_slots": "device tile batch slots run, padding included",
    "tile_useful_pct": "frame LR pixels over device tile slot LR pixels, "
                       "percent",
    "graph_captures": "CUDA graphs captured by this process",
    "graph_replays": "CUDA graph replays by this process",
    "kernel_builds": "nvcc builds of the port's CUDA kernels by this "
                     "process (a cold start's compiles)",
    "batched_calls": "dynamic batching: device forwards launched",
    "batched_tiles": "dynamic batching: tiles upscaled",
    "batch_fill_mean": "dynamic batching: mean batch fill fraction",
}

_PROM_COUNTERS = {"requests", "errors", "shed", "batched_calls",
                  "batched_tiles", "tiles", "tile_slots", "graph_captures",
                  "graph_replays", "kernel_builds"}


def _prometheus(metrics: dict) -> str:
    """Render the /metrics dict in Prometheus exposition format; the
    model kernels' counters take their help from their modules."""
    from torchsr_tpu_torch.ops import counter_help

    kernels = {k.lower(): v for k, v in counter_help().items()}
    lines = []
    for key, value in metrics.items():
        name = f"torchsr_{key}"
        if value is None:
            continue
        if isinstance(value, bool):
            value = int(value)
        help_text = _PROM_HELP.get(key, kernels.get(key))
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        kind = "counter" if key in _PROM_COUNTERS or key in kernels \
            else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


def _make_handler(service: _Service):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _send(
            self, code: int, body: bytes, ctype: str, headers=()
        ) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, value in headers:
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj, headers=()) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def do_GET(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                meta = service.meta
                self._send_json(200 if service.ready else 503, {
                    "status": "ok" if service.ready else "warming up",
                    "backend": meta.get("backend"),
                    "model": meta.get("model", ""),
                    "input_shape": meta.get("input_shape"),
                    "scale": meta.get("scale"),
                    "compute_dtype": meta.get("compute_dtype"),
                })
            elif path == "/metadata":
                self._send_json(200, service.meta)
            elif path == "/metrics":
                accept = self.headers.get("Accept", "")
                if "format=prometheus" in query or "text/plain" in accept:
                    self._send(
                        200, _prometheus(service.metrics()).encode(),
                        "text/plain; version=0.0.4",
                    )
                else:
                    self._send_json(200, service.metrics())
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path != "/upscale":
                self._send_json(404, {"error": f"no route {path}"})
                return
            if not service.ready:
                self._send_json(503, {"error": "warming up"})
                return
            opts = {"overlap": None, "fmt": "png", "quality": 92,
                    "compress": 6}
            for part in filter(None, query.split("&")):
                key, _, value = part.partition("=")
                try:
                    if key in ("overlap", "quality", "compress"):
                        opts[key] = int(value)
                    elif key == "format":
                        opts["fmt"] = value
                except ValueError:
                    self._send_json(400, {"error": f"bad {part!r}"})
                    return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._send_json(400, {"error": "empty request body"})
                return
            if (
                service.max_request_bytes
                and length > service.max_request_bytes
            ):
                # rejected before reading: the declared size is enough
                self._send_json(413, {
                    "error": f"request body {length} bytes exceeds the "
                             f"{service.max_request_bytes / 1e6:g} MB "
                             f"limit",
                })
                return
            body = self.rfile.read(length)
            if not service.admit():
                self._send_json(
                    503,
                    {"error": f"server saturated ({service.max_pending} "
                              f"upscales in flight); retry"},
                    headers=(("Retry-After", "1"),),
                )
                return
            # the slot is released before any response byte goes out,
            # so a sequential client is never shed by its own last call
            error = None
            try:
                payload, ctype = service.upscale_bytes(body, **opts)
            except RequestTooLarge as exc:
                error = (413, str(exc))
            except Exception as exc:  # undecodable image, bad params
                error = (400, str(exc))
            finally:
                service.release()
            if error is not None:
                self._send_json(error[0], {"error": error[1]})
                return
            self._send(200, payload, ctype)

    return Handler


def make_server(
    service: _Service,
    host: str = "127.0.0.1",
    port: int = 8765,
    warmup: bool = True,
) -> ThreadingHTTPServer:
    """Build (and warm up) the HTTP server around ``service``; the
    caller runs ``serve_forever()``.  ``port=0`` binds an ephemeral
    port (``server.server_address[1]`` reports it)."""
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service
    if warmup:
        service.warmup()
    return server


def run_server(args) -> None:
    """The ``serve`` subcommand: serve ``args.artifact``, or
    ``args.checkpoint`` (or the default ``{model}-gan-best``
    checkpoint), until SIGTERM or Ctrl-C."""
    import signal

    from torchsr_tpu_torch.parallel.mesh import local_devices

    limits = {"max_request_mb": args.max_request_mb,
              "max_input_mp": args.max_input_mp,
              "max_pending": args.max_pending}
    if getattr(args, "artifact", None):
        service: _Service = UpscaleService(
            args.artifact, overlap=args.tile_overlap or None,
            device=args.device, **limits)
        what = f"artifact {args.artifact}"
    else:
        service = CheckpointUpscaleService(
            model=args.model,
            checkpoint=args.checkpoint,
            tile=args.tile,
            tile_batch=args.tile_batch,
            overlap=args.tile_overlap or None,
            disable_amp=args.disable_amp,
            device=args.device,
            batch_requests=args.batch_requests,
            batch_wait_ms=args.batch_wait_ms,
            shard_devices=(local_devices(device=args.device)
                           if getattr(args, "shard_tiles", False) else None),
            **limits,
        )
        what = f"checkpoint {service.meta['checkpoint']}"
    server = make_server(service, host=args.host, port=args.port)

    # Graceful drain on SIGTERM: finish in-flight requests, stop
    # accepting, exit 0.  shutdown() must run off the main thread, which
    # is inside serve_forever; installed before the readiness print so a
    # supervisor that signals on first output never hits the default.
    def _terminate(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev = signal.signal(signal.SIGTERM, _terminate)
    except ValueError:  # not the main thread (library/test use)
        prev = None

    host, port = server.server_address[:2]
    print(
        f"Serving {service.meta.get('model') or 'model'} {what} on "
        f"{service.meta['device']} at "
        f"http://{host}:{port} (POST /upscale, GET /healthz, "
        f"GET /metrics)", flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        # handler threads are daemonic: wait (bounded) for in-flight
        # requests so a SIGTERM drain completes the work it admitted
        deadline = time.time() + 30
        while service.metrics()["in_flight"] > 0 and time.time() < deadline:
            time.sleep(0.05)
        service.close()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        stats = service.metrics()
        print(
            f"Server stopped cleanly after {stats['requests']} "
            f"requests ({stats['errors']} errors, up "
            f"{stats['uptime_s']} s)"
        )
