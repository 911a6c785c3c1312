"""HAT's two window attentions on NHWC token maps: one CUDA kernel, and
its plain version.

HAT (Chen et al., arXiv:2205.04437; ``hat/archs/hat_arch.py``) mixes
tokens in two ways inside each residual group:

* ``window_attn``, the HAB's (shifted) window self-attention: the map is
  rolled by ``-shift`` on both axes, cut into ``window`` x ``window``
  windows of N = window^2 tokens, and in each window and head the
  queries attend to the window's keys with a learned relative-position
  bias (``relative_position_bias_table`` gathered by ``sa_index``) and,
  on shifted blocks, HAT's -100 mask between the regions the roll
  brought together (``shift_mask``); the result is put back in token
  order and rolled by ``+shift``.
* ``overlap_attn``, the OCAB's overlapping cross-attention: the queries
  of each window attend to the ``overlap`` x ``overlap`` keys around it
  (stride ``window``, the map zero-padded by (overlap - window) / 2 as
  ``nn.Unfold`` pads the projected keys and values: a padded key is a
  zero vector that still takes part in the softmax with its bias), the
  bias gathered by ``oca_index``.

Both take ``qkv``, the qkv projection's output (B, H, W, 3C) with C =
heads x d (q, k, v, each head's d channels in turn, as ``hat_arch.py``
reshapes it), and the block's bias table (f32, (entries, heads)), and
return the (B, H, W, C) attention output in token order, ready for
``proj``.  Scores are ``(q * d^-0.5) . k + bias (+ mask)``, the softmax
over the keys.

The plain version (``window_attn_reference``, ``overlap_attn_reference``)
writes ``hat_arch.py``'s equations down: the roll, the window partition,
``nn.Unfold``, every score materialised, softmax, the products, the
window reverse; in f32 whatever the input's dtype, the result cast to
it.  The wrappers take it for CPU tensors only.  For CUDA tensors they
launch the kernel (``csrc/window_attn.cu``) or raise: bf16 only (an f32
form of the kernel does not exist yet, so f32 CUDA input raises and
names it), window 16, overlap 24, head dim even and at most 32, H and W
multiples of the window.  Forward only: nothing trains HAT.

The kernel replaces no TPU kernel (the JAX package has no HAT).  It was
added because the plain version writes and reads every score: at a tile
batch of (8, 256, 256, 180) a HAB call materialises 8 x 256 windows x 6
heads x 256^2 scores, about 0.8 G, several times over.  Its bound is
bytes: q, k and v read once (1080 bytes a token) and the output written
once (360 bytes a token) make 755 MB at that shape, 0.225 ms at 3.35
TB/s, against 96.6 GFLOP (0.098 ms at 989 TFLOP/s); an OCAB call moves
the same bytes against 217 GFLOP (0.22 ms).  The design: one CTA a
(window, head, image), q, k and v loaded once into shared memory from
the qkv map with the roll, the window partition and the unfold folded
into the addresses (a padded key is written as zeros), the scores kept
in registers (``mma.sync`` bf16 tensor-core products with f32 sums, an
online softmax in f32 over blocks of 64 keys), the bias gathered from
the head's table in shared memory by the relative offset, the mask
worked out from the regions of the two tokens, and the output written
in bf16 at the query's own position (the window reverse and the inverse
roll folded in).  Nothing is built per tile shape on the device, and
nothing on the host between launches, so the launches can be captured
in a CUDA graph.

Counters (plain integers, ``ops.MODEL_KERNELS``; ``train/graphs.py`` and
``infer/tiled.py`` add a captured graph's share once per replay):
``WINDOW_ATTN_LAUNCHES`` and ``OVERLAP_ATTN_LAUNCHES`` count kernel
launches; ``HAT_WINDOWS_HAB`` and ``HAT_WINDOWS_OCAB`` the attention
windows computed (window x head x image is one CTA: windows x images
here), by either version; ``HAT_PAD_PX`` the pixels the HAT generator
padded its input by to reach a window multiple (``models/hat.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

WINDOW_ATTN_LAUNCHES = 0
OVERLAP_ATTN_LAUNCHES = 0
HAT_WINDOWS_HAB = 0
HAT_WINDOWS_OCAB = 0
HAT_PAD_PX = 0
COUNTER_HELP = {
    "WINDOW_ATTN_LAUNCHES": "HAT window attention kernel launches",
    "OVERLAP_ATTN_LAUNCHES": "HAT overlapping cross-attention kernel "
                             "launches",
    "HAT_WINDOWS_HAB": "HAT attention windows of its HABs computed",
    "HAT_WINDOWS_OCAB": "HAT attention windows of its OCABs computed",
    "HAT_PAD_PX": "pixels HAT padded its input by to whole windows",
}
LAUNCH_COUNTERS = tuple(COUNTER_HELP)

# What the kernel takes (csrc/window_attn.cu).
KERNEL_WINDOW = 16
KERNEL_OVERLAP = 24
MAX_HEAD_DIM = 32
MASK_VALUE = -100.0


def count_pad(px: int) -> None:
    """Add ``px`` padded pixels to ``HAT_PAD_PX``."""
    global HAT_PAD_PX
    HAT_PAD_PX += int(px)


# ------------------------------------------------------------ indices


@functools.cache
def sa_index(window: int) -> torch.Tensor:
    """HAT's ``calculate_rpi_sa``: (N, N) int64 on the CPU, the bias
    table row of query i and key j of a window (N = window^2)."""
    ar = torch.arange(window)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.cache
def oca_index(window: int, overlap: int) -> torch.Tensor:
    """HAT's ``calculate_rpi_oca``: (N, M) int64 on the CPU, the bias
    table row of query i and key j of an overlapping window (M =
    overlap^2).  Some rows are negative, as ``hat_arch.py`` computes
    them; indexing the table wraps them (``table[idx]``), and the
    ``(window + overlap - 1)^2`` rows are each used once a pair of
    offsets."""
    ar_o, ar_e = torch.arange(window), torch.arange(overlap)
    ori = torch.stack(torch.meshgrid(ar_o, ar_o, indexing="ij")).flatten(1)
    ext = torch.stack(torch.meshgrid(ar_e, ar_e, indexing="ij")).flatten(1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - overlap + 1
    rel[:, :, 1] += window - overlap + 1
    rel[:, :, 0] *= window + overlap - 1
    return rel.sum(-1)


@functools.cache
def shift_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """HAT's ``calculate_mask`` for an (h, w) map: (windows, N, N) f32 on
    the CPU, 0 between tokens of one region of the rolled map and -100
    between tokens of two."""
    img = torch.zeros((1, h, w, 1))
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = partition(img, window).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return diff.masked_fill(diff != 0, MASK_VALUE).masked_fill(diff == 0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """``window_partition``: (B, H, W, C) -> (B * windows, window, window,
    C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def reverse(windows: torch.Tensor, window: int, h: int,
            w: int) -> torch.Tensor:
    """``window_reverse``: the inverse of ``partition``."""
    c = windows.shape[-1]
    x = windows.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


# ------------------------------------------------------------ plain version


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(windows, n, C) -> (windows, heads, n, d)."""
    nw, n, c = t.shape
    return t.reshape(nw, n, heads, c // heads).permute(0, 2, 1, 3)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(windows, heads, n, d) -> (windows, n, heads * d)."""
    nw, nh, n, d = t.shape
    return t.transpose(1, 2).reshape(nw, n, nh * d)


def window_attn_reference(qkv: torch.Tensor, table: torch.Tensor, *,
                          heads: int, window: int, shift: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The HAB's window attention as ``hat_arch.py`` computes it (module
    docstring), in f32; returns (B, H, W, C) in ``qkv``'s dtype."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    scale = (c // heads) ** -0.5 if scale is None else scale
    x = qkv.float()
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    n = window * window
    win = partition(x, window).reshape(-1, n, c3)
    q, k, v = (_heads(win[..., i * c:(i + 1) * c], heads) for i in range(3))
    attn = (q * scale) @ k.transpose(-2, -1)
    idx = sa_index(window).to(qkv.device)
    bias = table.float()[idx.view(-1)].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if shift:
        mask = shift_mask(h, w, window, shift).to(qkv.device)
        nw = mask.shape[0]
        attn = attn.view(b, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    out = _merge(attn.softmax(-1) @ v)
    out = reverse(out.view(-1, window, window, c), window, h, w)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out.to(qkv.dtype)


def overlap_attn_reference(qkv: torch.Tensor, table: torch.Tensor, *,
                           heads: int, window: int, overlap: int,
                           scale: float | None = None) -> torch.Tensor:
    """The OCAB's overlapping cross-attention as ``hat_arch.py``
    computes it (module docstring), in f32; returns (B, H, W, C) in
    ``qkv``'s dtype."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    scale = (c // heads) ** -0.5 if scale is None else scale
    x = qkv.float()
    n, m = window * window, overlap * overlap
    q = _heads(partition(x[..., :c], window).reshape(-1, n, c), heads)
    kv = F.unfold(x[..., c:].permute(0, 3, 1, 2), kernel_size=overlap,
                  stride=window, padding=(overlap - window) // 2)
    # 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
    kv = kv.view(b, 2, c, m, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, m, c)
    k, v = _heads(kv[0], heads), _heads(kv[1], heads)
    attn = (q * scale) @ k.transpose(-2, -1)
    idx = oca_index(window, overlap).to(qkv.device)
    bias = table.float()[idx.view(-1)].view(n, m, -1).permute(2, 0, 1)
    out = _merge((attn + bias.unsqueeze(0)).softmax(-1) @ v)
    return reverse(out.view(-1, window, window, c), window, h,
                   w).to(qkv.dtype)


# ------------------------------------------------------------ wrappers


def _count_windows(name: str, qkv: torch.Tensor, window: int) -> None:
    b, h, w, _ = qkv.shape
    globals()[name] += b * (h // window) * (w // window)


def _check(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
           entries: int) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, H, W, 3C), got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    if h % window or w % window:
        raise ValueError(f"the map ({h}, {w}) is not a whole number of "
                         f"{window}x{window} windows")
    if (c3 // 3) % heads:
        raise ValueError(f"C = {c3 // 3} is not a multiple of {heads} heads")
    if tuple(table.shape) != (entries, heads):
        raise ValueError(f"the bias table must be ({entries}, {heads}), got "
                         f"{tuple(table.shape)}")


def _kernel_checks(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                   window: int, overlap: int | None, what: str) -> None:
    """Raise on what the kernel does not take."""
    if qkv.dtype == torch.float32:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is bf16 only; an f32 form of it does "
            f"not exist yet (serve HAT without --disable-amp, or run the "
            f"plain version on the CPU)")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16 on CUDA, not {qkv.dtype}")
    d = qkv.shape[-1] // 3 // heads
    if window != KERNEL_WINDOW or overlap not in (None, KERNEL_OVERLAP):
        raise ValueError(
            f"{what}: the kernel takes window {KERNEL_WINDOW} (overlap "
            f"{KERNEL_OVERLAP}), got {window} ({overlap})")
    if d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes an even head dim of at "
                         f"most {MAX_HEAD_DIM}, got {d}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what} takes a contiguous, 16-byte aligned qkv")
    if (table.device != qkv.device or table.dtype != torch.float32
            or not table.is_contiguous()):
        raise ValueError(f"{what} takes a contiguous f32 bias table on "
                         f"{qkv.device}")


def _launch(qkv: torch.Tensor, table: torch.Tensor, heads: int,
            shift: int, overlap: int, scale: float) -> torch.Tensor:
    from torchsr_tpu_torch.ops._build import load_library
    from torchsr_tpu_torch.ops.rdb import _raise_on

    b, h, w, c3 = qkv.shape
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype,
                      device=qkv.device)
    lib = load_library("window_attn")
    dev = qkv.device
    err = lib.window_attn_launch(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c3 // 3,
        heads, shift, overlap, float(scale), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.window_attn_error_string,
              "overlap_attn" if overlap else "window_attn")
    return out


def window_attn(qkv: torch.Tensor, table: torch.Tensor, *, heads: int,
                window: int, shift: int = 0,
                scale: float | None = None) -> torch.Tensor:
    """The HAB's (shifted) window attention (module docstring): the
    plain version on the CPU, the kernel on CUDA."""
    global WINDOW_ATTN_LAUNCHES
    _check(qkv, table, heads, window, (2 * window - 1) ** 2)
    scale = (qkv.shape[-1] // 3 // heads) ** -0.5 if scale is None else scale
    if qkv.device.type == "cpu":
        out = window_attn_reference(qkv, table, heads=heads, window=window,
                                    shift=shift, scale=scale)
    elif qkv.device.type == "cuda":
        _kernel_checks(qkv, table, heads, window, None, "window_attn")
        if not 0 <= shift < window:
            raise ValueError(f"window_attn: shift {shift} outside [0, "
                             f"{window})")
        out = _launch(qkv, table, heads, shift, 0, scale)
        WINDOW_ATTN_LAUNCHES += 1
    else:
        raise ValueError(f"window_attn runs on CUDA (kernel) or the CPU "
                         f"(plain version), not on {qkv.device}")
    _count_windows("HAT_WINDOWS_HAB", qkv, window)
    return out


def overlap_attn(qkv: torch.Tensor, table: torch.Tensor, *, heads: int,
                 window: int, overlap: int,
                 scale: float | None = None) -> torch.Tensor:
    """The OCAB's overlapping cross-attention (module docstring): the
    plain version on the CPU, the kernel on CUDA."""
    global OVERLAP_ATTN_LAUNCHES
    if (overlap - window) % 2 or overlap < window:
        raise ValueError(f"overlap {overlap} must exceed window {window} by "
                         f"an even number")
    _check(qkv, table, heads, window, (window + overlap - 1) ** 2)
    scale = (qkv.shape[-1] // 3 // heads) ** -0.5 if scale is None else scale
    if qkv.device.type == "cpu":
        out = overlap_attn_reference(qkv, table, heads=heads, window=window,
                                     overlap=overlap, scale=scale)
    elif qkv.device.type == "cuda":
        _kernel_checks(qkv, table, heads, window, overlap, "overlap_attn")
        out = _launch(qkv, table, heads, 0, overlap, scale)
        OVERLAP_ATTN_LAUNCHES += 1
    else:
        raise ValueError(f"overlap_attn runs on CUDA (kernel) or the CPU "
                         f"(plain version), not on {qkv.device}")
    _count_windows("HAT_WINDOWS_OCAB", qkv, window)
    return out
