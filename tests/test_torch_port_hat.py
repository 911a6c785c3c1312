"""HAT (``models/hat.py``, ``ops/window_attn.py``) on the CPU, at tiny
widths (embed 24, 2 heads, window 4, depths [2, 2], compress 3, squeeze
6) with seeded random weights.

The port's generator against the benchmark's plain f32 reference
(``port_bench/reference/hat.py``, written from ``hat_arch.py``) on a
16x16 input and on an 18x22 one, which HAT reflect-pads to 20x24; the
plain window attentions against an independent restatement (dense
attention over the whole map, each pair's bias and mask worked out from
its coordinates, the OCAB's keys on a zero-padded map); the relative-
position indices and the shift mask against ``hat_arch.py``'s code
written out here; state dicts in ``hat_arch.py``'s layout (``params_ema``
and ``params``) and ``sized_to``; the registry, the service at a tiny
tile, the counters and what the kernel path refuses.
"""

from __future__ import annotations

import json
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import weights
from port_bench.reference import hat as ref
from port_bench.reference import tiling
from torchsr_tpu_torch.models.hat import HATGenerator
from torchsr_tpu_torch.ops import window_attn as wa

ROOT = Path(__file__).resolve().parents[1]
CFG = {**json.loads((ROOT / "port_bench/configs/hat.json").read_text()),
       "embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2],
       "window_size": 4, "compress_ratio": 3, "squeeze_factor": 6}
# f32 on both sides, the same operations in other groupings (NHWC tokens
# against hat_arch.py's sequences, one matmul against its batched
# products): rounding of f32 sums over at most ~100 terms a layer, through
# 2 x (2 HABs + OCAB) and the tail; the outputs spread ~0.1, so 1e-5
# absolute is ~1e-4 of them.
NET_ATOL = 1e-5
# the attention alone: one softmax and two products of f32
ATTN_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seeded():
    w = weights.make(ref.generator_specs(CFG), 11, "generator", "cpu")
    gen = HATGenerator.sized_to(w)
    weights.load_into(gen, w)
    return w, gen.eval().requires_grad_(False)


# ------------------------------------------------------------ generator


@pytest.mark.parametrize("hw", [(16, 16), (18, 22)], ids=["16x16", "18x22"])
def test_generator_against_the_reference(seeded, hw):
    w, gen = seeded
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, *hw, 3), np.float32))
    with torch.no_grad():
        got = gen(x)
        want = ref.generator(w, x.permute(0, 3, 1, 2), CFG).permute(
            0, 2, 3, 1)
    assert got.shape == (2, hw[0] * 4, hw[1] * 4, 3)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=NET_ATOL)
    assert 0.02 < float(want.std()) < 0.5   # a spread, not a flat output


@pytest.mark.parametrize("hw, pad", [((16, 16), 0), ((18, 22), 20 * 24 -
                                                     18 * 22)],
                         ids=["whole", "padded"])
def test_pad_and_window_counters(seeded, hw, pad):
    _, gen = seeded
    before = {n: getattr(wa, n) for n in wa.LAUNCH_COUNTERS}
    with torch.no_grad():
        gen(torch.rand(2, *hw, 3))
    delta = {n: getattr(wa, n) - before[n] for n in wa.LAUNCH_COUNTERS}
    ph, pw = -(-hw[0] // 4) * 4, -(-hw[1] // 4) * 4
    wins = 2 * (ph // 4) * (pw // 4)
    assert delta == {"WINDOW_ATTN_LAUNCHES": 0, "OVERLAP_ATTN_LAUNCHES": 0,
                     "HAT_WINDOWS_HAB": 4 * wins, "HAT_WINDOWS_OCAB": 2 * wins,
                     "HAT_PAD_PX": 2 * pad}


def test_rgb_mean_is_a_buffer_outside_the_state_dict(seeded):
    """The mean moves with the module and is not a key: hat_arch.py
    keeps it as a plain attribute, so a published state_dict has none."""
    _, gen = seeded
    assert dict(gen.named_buffers())["rgb_mean"].tolist() == pytest.approx(
        [0.4488, 0.4371, 0.4040])
    assert not any("mean" in k for k in gen.state_dict())
    assert gen.rgb_mean.dtype == torch.float32


# ------------------------------------------------------------ attention


def _rel_table(table: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
               side: int) -> torch.Tensor:
    """table[(dy * side + dx) mod rows] for offset maps (..), (heads,
    ...)."""
    idx = (dy * side + dx) % table.shape[0]
    return table[idx].movedim(-1, 0)


def _dense(q, k, v, scores_extra, allowed):
    """softmax over the allowed keys of q . k * scale + extra, times v:
    (heads, N, d) each, (heads, N, M) extra, (N, M) allowed."""
    d = q.shape[-1]
    s = (q * d ** -0.5) @ k.transpose(-2, -1) + scores_extra
    s = s.masked_fill(~allowed, float("-inf"))
    return s.softmax(-1) @ v


def _restated_hab(qkv, table, heads, ws, shift):
    """Dense attention over the whole map: keys of the query's window
    in the rolled map, bias by the two tokens' offset, -100 between
    HAT's regions (cut at H - ws and H - shift on each axis)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    # each token's place in the rolled map (the map rolled by -shift)
    ry, rx = (ys - shift) % h, (xs - shift) % w
    ry, rx = ry.flatten(), rx.flatten()
    same = ((ry[:, None] // ws == ry[None, :] // ws)
            & (rx[:, None] // ws == rx[None, :] // ws))
    dy = ry[:, None] - ry[None, :] + ws - 1
    dx = rx[:, None] - rx[None, :] + ws - 1
    bias = _rel_table(table, dy, dx, 2 * ws - 1)
    if shift:
        def region(p, n):
            return (p >= n - ws).long() + (p >= n - shift).long()
        rid = region(ry, h) * 3 + region(rx, w)
        bias = bias + torch.where(rid[:, None] != rid[None, :], -100.0, 0.0)
    out = torch.empty(b, h * w, c)
    for i in range(b):
        t = qkv[i].reshape(h * w, 3, heads, c // heads).permute(1, 2, 0, 3)
        o = _dense(t[0], t[1], t[2], bias, same)
        out[i] = o.permute(1, 0, 2).reshape(h * w, c)
    return out.view(b, h, w, c)


def _restated_ocab(qkv, table, heads, ws, ows):
    """Each query against the ows x ows keys around its window on the
    map zero-padded by (ows - ws) / 2 (keys of zeros count), bias by
    HAT's offset (ext - ori + ws - ows + 1 per axis, table side ws + ows
    - 1, negative rows from the end)."""
    b, h, w, c3 = qkv.shape
    c, p = c3 // 3, (ows - ws) // 2
    kv = torch.nn.functional.pad(qkv[..., c:], (0, 0, p, p, p, p))
    hp, wp = h + 2 * p, w + 2 * p
    qy, qx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(hp), torch.arange(wp),
                            indexing="ij")
    qy, qx, ky, kx = qy.flatten(), qx.flatten(), ky.flatten(), kx.flatten()
    # the key window of a query's window starts at its window's corner
    # in the padded map
    ey = ky[None, :] - (qy[:, None] // ws) * ws
    ex = kx[None, :] - (qx[:, None] // ws) * ws
    allowed = (ey >= 0) & (ey < ows) & (ex >= 0) & (ex < ows)
    oy, ox = qy[:, None] % ws, qx[:, None] % ws
    bias = _rel_table(table, ey - oy + ws - ows + 1, ex - ox + ws - ows + 1,
                      ws + ows - 1)
    out = torch.empty(b, h * w, c)
    d = c // heads
    for i in range(b):
        q = qkv[i, ..., :c].reshape(h * w, heads, d).transpose(0, 1)
        kk = kv[i, ..., :c].reshape(hp * wp, heads, d).transpose(0, 1)
        vv = kv[i, ..., c:].reshape(hp * wp, heads, d).transpose(0, 1)
        out[i] = _dense(q, kk, vv, bias, allowed).transpose(0, 1).reshape(
            h * w, c)
    return out.view(b, h, w, c)


@pytest.mark.parametrize("kind, shift", [("hab", 0), ("hab", 2), ("ocab", 0)],
                         ids=["hab", "hab-shifted", "ocab"])
def test_plain_attention_against_the_restatement(kind, shift):
    rng = np.random.default_rng(5)
    heads, ws, ows = 2, 4, 6
    qkv = torch.from_numpy(rng.standard_normal((2, 8, 12, 3 * 12),
                                               np.float32))
    rows = (ws + ows - 1) ** 2 if kind == "ocab" else (2 * ws - 1) ** 2
    table = torch.from_numpy(rng.standard_normal((rows, heads), np.float32))
    if kind == "ocab":
        got = wa.overlap_attn(qkv, table, heads=heads, window=ws,
                              overlap=ows)
        want = _restated_ocab(qkv, table, heads, ws, ows)
    else:
        got = wa.window_attn(qkv, table, heads=heads, window=ws, shift=shift)
        want = _restated_hab(qkv, table, heads, ws, shift)
    torch.testing.assert_close(got, want, rtol=0, atol=ATTN_ATOL)


def test_zero_padded_keys_take_part():
    """An edge window's softmax runs over its zero keys too: with every
    key of the map zeroed but the bias kept, each output is the
    bias-weighted mean of the values, here zero; with values of one
    everywhere inside the map, an edge query's output is below one (the
    padded keys carry zero values and softmax weight)."""
    heads, ws, ows = 1, 4, 6
    qkv = torch.zeros(1, 8, 8, 3 * 4)
    qkv[..., 8:] = 1.0                                  # v = 1 in the map
    table = torch.zeros((ws + ows - 1) ** 2, heads)
    out = wa.overlap_attn(qkv, table, heads=heads, window=ws, overlap=ows)
    # window (0, 0) sees 6 x 6 keys of which 5 x 5 lie in the map
    assert float(out[0, 0, 0, 0]) == pytest.approx(25 / 36)
    # an interior window of a larger map sees no padding
    big = torch.zeros(1, 12, 12, 12)
    big[..., 8:] = 1.0
    out = wa.overlap_attn(big, table, heads=heads, window=ws, overlap=ows)
    assert float(out[0, 5, 5, 0]) == pytest.approx(1.0)


# ------------------------------------------------------------ indices


def _hat_rpi_sa(window_size):
    """hat_arch.py HAT.calculate_rpi_sa, as written there."""
    coords_h = torch.arange(window_size)
    coords_w = torch.arange(window_size)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size - 1
    relative_coords[:, :, 1] += window_size - 1
    relative_coords[:, :, 0] *= 2 * window_size - 1
    return relative_coords.sum(-1)


def _hat_rpi_oca(window_size, overlap_ratio):
    """hat_arch.py HAT.calculate_rpi_oca, as written there."""
    window_size_ori = window_size
    window_size_ext = window_size + int(overlap_ratio * window_size)
    coords_h = torch.arange(window_size_ori)
    coords_w = torch.arange(window_size_ori)
    coords_ori = torch.stack(torch.meshgrid([coords_h, coords_w],
                                            indexing="ij"))
    coords_ori_flatten = torch.flatten(coords_ori, 1)
    coords_h = torch.arange(window_size_ext)
    coords_w = torch.arange(window_size_ext)
    coords_ext = torch.stack(torch.meshgrid([coords_h, coords_w],
                                            indexing="ij"))
    coords_ext_flatten = torch.flatten(coords_ext, 1)
    relative_coords = coords_ext_flatten[:, None, :] \
        - coords_ori_flatten[:, :, None]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size_ori - window_size_ext + 1
    relative_coords[:, :, 1] += window_size_ori - window_size_ext + 1
    relative_coords[:, :, 0] *= window_size_ori + window_size_ext - 1
    return relative_coords.sum(-1)


def _hat_mask(h, w, window_size, shift_size):
    """hat_arch.py HAT.calculate_mask, as written there."""
    img_mask = torch.zeros((1, h, w, 1))
    h_slices = (slice(0, -window_size), slice(-window_size, -shift_size),
                slice(-shift_size, None))
    w_slices = (slice(0, -window_size), slice(-window_size, -shift_size),
                slice(-shift_size, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    x = img_mask.view(1, h // window_size, window_size, w // window_size,
                      window_size, 1)
    mask_windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size * window_size)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


@pytest.mark.parametrize("ws", [4, 16])
def test_indices_are_hat_arch(ws):
    assert torch.equal(wa.sa_index(ws), _hat_rpi_sa(ws))
    assert torch.equal(wa.oca_index(ws, ws + ws // 2), _hat_rpi_oca(ws, 0.5))
    assert torch.equal(ref.rpi_sa(ws), _hat_rpi_sa(ws))
    assert torch.equal(ref.rpi_oca(ws, ws + ws // 2), _hat_rpi_oca(ws, 0.5))


def test_oca_index_uses_every_row_once_a_pair():
    idx = wa.oca_index(16, 24)
    rows = (16 + 24 - 1) ** 2
    assert int(idx.min()) == -880 and int(idx.max()) == 640
    assert len(torch.unique(idx % rows)) == rows


@pytest.mark.parametrize("hw, ws, shift", [((16, 16), 4, 2), ((20, 24), 4, 2),
                                           ((32, 48), 16, 8)])
def test_shift_mask_is_hat_arch(hw, ws, shift):
    assert torch.equal(wa.shift_mask(*hw, ws, shift), _hat_mask(*hw, ws,
                                                                 shift))


# ------------------------------------------------------------ state dicts


@pytest.mark.parametrize("wrapper", ["params_ema", "params", None])
def test_state_dict_round_trip(seeded, tmp_path, wrapper):
    """A ``hat_arch.py``-layout checkpoint (its two index buffers
    included, under ``params_ema``, ``params`` or bare) loads through the
    port's checkpoint reader and ``sized_to`` into the same generator."""
    from torchsr_tpu_torch.utils.checkpoint import load_checkpoint

    _, gen = seeded
    sd = gen.state_dict()
    assert {"relative_position_index_SA", "relative_position_index_OCA",
            "conv_first.weight", "patch_embed.norm.weight",
            "layers.1.residual_group.blocks.1.attn.qkv.weight",
            "layers.1.residual_group.blocks.1.attn."
            "relative_position_bias_table",
            "layers.0.residual_group.blocks.0.conv_block.cab.3.attention.1."
            "weight",
            "layers.0.residual_group.overlap_attn.relative_position_bias_"
            "table",
            "layers.0.conv.weight", "norm.bias", "conv_after_body.weight",
            "conv_before_upsample.0.weight", "upsample.0.weight",
            "upsample.2.weight", "conv_last.weight"} <= set(sd)
    path = tmp_path / "HAT_SRx4.pth"
    torch.save(sd if wrapper is None else {wrapper: sd}, path)
    state = load_checkpoint(str(path), "hat")["state"]
    back = HATGenerator.sized_to(state)
    back.load_state_dict(state)
    assert (back.depths, back.num_heads, back.window_size, back.overlap_size,
            back.embed_dim, back.scale_factor) == ((2, 2), (2, 2), 4, 6, 24,
                                                   4)
    x = torch.rand(1, 8, 12, 3)
    with torch.no_grad():
        assert torch.equal(back(x), gen(x))


def test_wrong_index_buffer_refused(seeded):
    _, gen = seeded
    sd = gen.state_dict()
    sd["relative_position_index_OCA"] = sd["relative_position_index_OCA"] + 1
    with pytest.raises(ValueError, match="relative_position_index_OCA"):
        HATGenerator.sized_to(sd).load_state_dict(sd)


def test_srx4_size():
    gen = HATGenerator(device="meta")
    assert sum(p.numel() for p in gen.parameters()) == json.loads(
        (ROOT / "port_bench/configs/hat.json").read_text())[
        "generator_parameters"] == 20_772_507
    assert gen.overlap_size == 24 and len(gen.layers) == 6


# ------------------------------------------------------------ entry points


def test_registry():
    from torchsr_tpu_torch.registry import (
        MODEL_NAMES,
        select_test_model,
        select_trainer_model,
    )

    assert "hat" in MODEL_NAMES
    assert select_test_model(Namespace(model="HAT")) is HATGenerator
    with pytest.raises(RuntimeError, match="served and tested only"):
        select_trainer_model(Namespace(model="hat"))


def test_service_at_a_tiny_tile(seeded, tmp_path):
    """The checkpoint service on the CPU against the reference's tiled
    upscale of the same frame (f32 both; a level may round the other
    way at a tie), and the HAT counters in its /metrics."""
    from torchsr_tpu_torch.infer.server import CheckpointUpscaleService
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    w, _ = seeded
    path = str(tmp_path / "hat-seeded.pth")
    save_checkpoint(path, 1, "hat-gan", w)
    svc = CheckpointUpscaleService("hat", checkpoint=path, tile=16,
                                   tile_batch=4, overlap=4, device="cpu")
    frame = np.random.default_rng(9).integers(0, 256, (20, 26, 3), np.uint8)
    got = svc._guarded_upscale(frame, 4)
    with torch.no_grad():
        want = tiling.upscale(
            torch.from_numpy(frame), lambda x: ref.generator(w, x, CFG),
            scale=4, tile=16, overlap=4, batch=4).numpy()
    assert got.shape == (80, 104, 3) and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    m = svc.metrics()
    assert m["hat_windows_hab"] > 0 and m["hat_windows_ocab"] > 0
    assert m["window_attn_launches"] == m["overlap_attn_launches"] == 0


def test_kernel_path_refusals():
    """What the CUDA wrapper refuses, checked on CPU tensors (the checks
    run before any launch): f32 names the missing f32 kernel; another
    window or an odd head dim is refused."""
    qkv = torch.zeros(1, 16, 16, 3 * 12)
    table = torch.zeros(31 * 31, 2)
    with pytest.raises(NotImplementedError, match="f32 form"):
        wa._kernel_checks(qkv, table, 2, 16, None, "window_attn")
    with pytest.raises(ValueError, match="window 16"):
        wa._kernel_checks(qkv.bfloat16(), table, 2, 8, None, "window_attn")
    with pytest.raises(ValueError, match="even head dim"):
        wa._kernel_checks(torch.zeros(1, 16, 16, 3 * 14).bfloat16(), table,
                          2, 16, None, "window_attn")
    with pytest.raises(ValueError, match="whole number"):
        wa.window_attn(torch.zeros(1, 6, 8, 36), torch.zeros(49, 2),
                       heads=2, window=4)


def test_prometheus_types_every_model_kernel_counter():
    """/metrics' Prometheus text gives every model kernel counter (RDB,
    BatchNorm, HAT) its module's help line and the counter type."""
    from torchsr_tpu_torch.infer.server import _prometheus
    from torchsr_tpu_torch.ops import counter_help, launch_counts

    counts = {k.lower(): v for k, v in launch_counts().items()}
    text = _prometheus(counts)
    assert set(counter_help()) == set(launch_counts())
    for key in counts:
        assert f"# TYPE torchsr_{key} counter" in text
        assert f"# HELP torchsr_{key} " in text
