"""HAT, the Hybrid Attention Transformer (Chen et al., CVPR, 2023,
arXiv:2205.04437; XPixelGroup/HAT ``hat/archs/hat_arch.py``), plain f32
PyTorch: tokens as (B, H*W, C) sequences and NCHW maps, as
``hat_arch.py`` holds them.

Generator (``upsampler="pixelshuffle"``, ``resi_connection="1conv"``,
``patch_norm``, no absolute position embedding, no dropout):
``x = (x - mean) * img_range`` (mean 0.4488, 0.4371, 0.4040);
``conv_first`` 3x3; LayerNorm (``patch_embed.norm``); residual hybrid
attention groups, each ``x + conv3x3(OCAB(HAB(...HAB(x))))``; LayerNorm
(``norm``); ``conv_after_body(.) + conv_first's output``;
``conv_before_upsample`` 3x3 to 64 and LeakyReLU 0.01; per x2 stage a 3x3
conv to 256 and ``PixelShuffle(2)``; ``conv_last`` 3x3 to 3;
``x / img_range + mean``.  An input whose sides are not multiples of the
window is reflect-padded at its bottom and right and the output cropped
(HAT's ``pre_process`` / ``post_process``).

HAB: ``n = LN1(x)``; the CAB ``conv3x3(C -> C/compress)``, GELU,
``conv3x3(C/compress -> C)``, channel attention (global average pool,
``conv1x1(C -> C/squeeze)``, ReLU, ``conv1x1(C/squeeze -> C)``, sigmoid,
times its input); window attention on ``n`` rolled by ``-shift`` (shift
0 on even blocks, window/2 on odd ones), cut into windows: ``qkv``
(with bias), ``q * d^-0.5``, ``q k^T`` plus the relative-position bias
(``calculate_rpi_sa``) plus, when shifted, ``calculate_mask``'s -100
between regions, softmax, times ``v``, ``proj``, windows put back and
rolled by ``+shift``; ``x = x + attn + conv_scale * cab``;
``x = x + fc2(GELU(fc1(LN2(x))))``.  OCAB: ``qkv(LN1(x))``, q in
windows, k and v through ``nn.Unfold(overlap, stride window, padding
(overlap - window) / 2)`` (zero keys at the map's edge, in the softmax
with their bias), ``q k^T`` plus the bias of ``calculate_rpi_oca`` (its
negative rows index the table from its end), softmax, times ``v``,
windows put back, ``proj``, the skip, and the MLP block.  GELU is exact.

Departures from ``hat_arch.py``: none intended.  Its two index buffers
are recomputed here from its formulas, not read.

Each conv, linear layer and both attention products take ``prec``
(``ops.operand``), so the control's fp8 and bf16 readings round every
product's operands.

Seeded initialization (``generator_specs``; the benchmark draws the
values, normal draws): HAT's ``_init_weights`` for the linear layers
(std 0.02, biases 0), the bias tables (std 0.02; HAT's truncated normal
cuts at +-2, which a draw of std 0.02 never reaches in practice) and
LayerNorm (1, 0); the convolutions at the variance of PyTorch's default
uniform draw, ``1 / (3 fan_in)``, weights and biases, but
``conv_last`` at ``conv_last_std`` times that deviation, so that a
random generator's output spreads over [0, 1] around the mean instead
of sitting on it (a flat output would hide the trunk from the check)
and is not clamped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import ops

MEAN = (0.4488, 0.4371, 0.4040)
NUM_FEAT = 64


def _sizes(cfg: dict) -> dict:
    c, ws = cfg["embed_dim"], cfg["window_size"]
    return {"c": c, "ws": ws, "ows": ws + int(cfg["overlap_ratio"] * ws),
            "hidden": int(c * cfg["mlp_ratio"]),
            "cab": c // cfg["compress_ratio"],
            "ca": c // cfg["squeeze_factor"]}


def _default(name: str, shape: tuple, scale: float = 1.0) -> list:
    fan_in = math.prod(shape[1:])
    std = 1.0 / math.sqrt(3.0 * fan_in)
    return [(f"{name}.weight", shape, scale * std, 0.0),
            (f"{name}.bias", (shape[0],), std, 0.0)]


def _linear(name: str, n_out: int, n_in: int) -> list:
    return [(f"{name}.weight", (n_out, n_in), 0.02, 0.0),
            (f"{name}.bias", (n_out,), 0.0, 0.0)]


def _norm(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), 0.0, 1.0), (f"{name}.bias", (c,), 0.0,
                                                  0.0)]


def generator_specs(cfg: dict) -> list:
    """(name, shape, std, mean) of every generator parameter."""
    z = _sizes(cfg)
    c, ws, ows, hid = z["c"], z["ws"], z["ows"], z["hidden"]
    specs = _default("conv_first", (c, 3, 3, 3)) + _norm("patch_embed.norm",
                                                         c)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            b = f"{g}.blocks.{j}"
            specs += _norm(f"{b}.norm1", c)
            specs.append((f"{b}.attn.relative_position_bias_table",
                          ((2 * ws - 1) ** 2, heads), 0.02, 0.0))
            specs += _linear(f"{b}.attn.qkv", 3 * c, c)
            specs += _linear(f"{b}.attn.proj", c, c)
            specs += _default(f"{b}.conv_block.cab.0", (z["cab"], c, 3, 3))
            specs += _default(f"{b}.conv_block.cab.2", (c, z["cab"], 3, 3))
            specs += _default(f"{b}.conv_block.cab.3.attention.1",
                              (z["ca"], c, 1, 1))
            specs += _default(f"{b}.conv_block.cab.3.attention.3",
                              (c, z["ca"], 1, 1))
            specs += _norm(f"{b}.norm2", c)
            specs += _linear(f"{b}.mlp.fc1", hid, c)
            specs += _linear(f"{b}.mlp.fc2", c, hid)
        o = f"{g}.overlap_attn"
        specs += _norm(f"{o}.norm1", c)
        specs += _linear(f"{o}.qkv", 3 * c, c)
        specs.append((f"{o}.relative_position_bias_table",
                      ((ws + ows - 1) ** 2, heads), 0.02, 0.0))
        specs += _linear(f"{o}.proj", c, c)
        specs += _norm(f"{o}.norm2", c)
        specs += _linear(f"{o}.mlp.fc1", hid, c)
        specs += _linear(f"{o}.mlp.fc2", c, hid)
        specs += _default(f"layers.{i}.conv", (c, c, 3, 3))
    specs += _norm("norm", c)
    specs += _default("conv_after_body", (c, c, 3, 3))
    specs += _default("conv_before_upsample.0", (NUM_FEAT, c, 3, 3))
    for k in range(int(math.log2(cfg["scale"]))):
        specs += _default(f"upsample.{2 * k}", (4 * NUM_FEAT, NUM_FEAT, 3, 3))
    return specs + _default("conv_last", (3, NUM_FEAT, 3, 3),
                            cfg["conv_last_std"])


# ------------------------------------------------------------ indices


def rpi_sa(ws: int) -> torch.Tensor:
    """``calculate_rpi_sa``."""
    coords_h = torch.arange(ws)
    coords_w = torch.arange(ws)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - 1
    relative_coords[:, :, 1] += ws - 1
    relative_coords[:, :, 0] *= 2 * ws - 1
    return relative_coords.sum(-1)


def rpi_oca(ws: int, ows: int) -> torch.Tensor:
    """``calculate_rpi_oca``."""
    coords_h = torch.arange(ws)
    coords_w = torch.arange(ws)
    coords_ori = torch.stack(torch.meshgrid([coords_h, coords_w],
                                            indexing="ij"))
    coords_ori_flatten = torch.flatten(coords_ori, 1)
    coords_h = torch.arange(ows)
    coords_w = torch.arange(ows)
    coords_ext = torch.stack(torch.meshgrid([coords_h, coords_w],
                                            indexing="ij"))
    coords_ext_flatten = torch.flatten(coords_ext, 1)
    relative_coords = (coords_ext_flatten[:, None, :]
                       - coords_ori_flatten[:, :, None])
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - ows + 1
    relative_coords[:, :, 1] += ws - ows + 1
    relative_coords[:, :, 0] *= ws + ows - 1
    return relative_coords.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(h: int, w: int, ws: int, shift: int,
                   device) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1), device=device)
    h_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    w_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in h_slices:
        for wsl in w_slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(
        attn_mask == 0, 0.0)


# ------------------------------------------------------------ blocks


def _ln(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"],
                        w[f"{name}.bias"], 1e-5)


def _lin(w: dict, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    return ops.dense(x, w[f"{name}.weight"], w[f"{name}.bias"], prec)


def _mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return ops.operand(a, prec) @ ops.operand(b, prec)


def _mlp(w: dict, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    return _lin(w, f"{name}.fc2", F.gelu(_lin(w, f"{name}.fc1", x, prec)),
                prec)


def _cab(w: dict, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    """``CAB`` on an NCHW map."""
    c = f"{name}.cab"
    y = ops.conv(x, w[f"{c}.0.weight"], w[f"{c}.0.bias"], prec)
    y = ops.conv(F.gelu(y), w[f"{c}.2.weight"], w[f"{c}.2.bias"], prec)
    a = y.mean((2, 3), keepdim=True)
    a = F.relu(ops.conv(a, w[f"{c}.3.attention.1.weight"],
                        w[f"{c}.3.attention.1.bias"], prec))
    a = torch.sigmoid(ops.conv(a, w[f"{c}.3.attention.3.weight"],
                               w[f"{c}.3.attention.3.bias"], prec))
    return y * a


def _attention(q, k, v, bias, mask, prec: str):
    """softmax(q k^T + bias (+ mask)) v over (windows, heads, n, d)."""
    attn = _mm(q, k.transpose(-2, -1), prec) + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        b_, nh, n, m = attn.shape
        attn = attn.view(b_ // nw, nw, nh, n, m) + mask.unsqueeze(1) \
            .unsqueeze(0)
        attn = attn.view(-1, nh, n, m)
    return _mm(attn.softmax(-1), v, prec)


def hab(w: dict, name: str, x: torch.Tensor, size: tuple, heads: int,
        shift: int, cfg: dict, prec: str) -> torch.Tensor:
    h, wd = size
    b, _, c = x.shape
    ws = cfg["window_size"]
    shortcut = x
    x = _ln(w, f"{name}.norm1", x).view(b, h, wd, c)
    conv_x = _cab(w, f"{name}.conv_block", x.permute(0, 3, 1, 2), prec)
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * wd, c)
    if shift > 0:
        shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        mask = calculate_mask(h, wd, ws, shift, x.device)
    else:
        shifted, mask = x, None
    xw = window_partition(shifted, ws).view(-1, ws * ws, c)
    b_, n, _ = xw.shape
    qkv = _lin(w, f"{name}.attn.qkv", xw, prec).reshape(
        b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    table = w[f"{name}.attn.relative_position_bias_table"]
    bias = table[rpi_sa(ws).to(x.device).view(-1)].view(n, n, -1)
    out = _attention(q, k, v, bias.permute(2, 0, 1).contiguous(), mask, prec)
    out = _lin(w, f"{name}.attn.proj",
               out.transpose(1, 2).reshape(b_, n, c), prec)
    shifted = window_reverse(out.view(-1, ws, ws, c), ws, h, wd)
    attn_x = (torch.roll(shifted, shifts=(shift, shift), dims=(1, 2))
              if shift > 0 else shifted).view(b, h * wd, c)
    x = shortcut + attn_x + conv_x * cfg["conv_scale"]
    return x + _mlp(w, f"{name}.mlp", _ln(w, f"{name}.norm2", x), prec)


def ocab(w: dict, name: str, x: torch.Tensor, size: tuple, heads: int,
         cfg: dict, prec: str) -> torch.Tensor:
    h, wd = size
    b, _, c = x.shape
    z = _sizes(cfg)
    ws, ows = z["ws"], z["ows"]
    shortcut = x
    x = _ln(w, f"{name}.norm1", x).view(b, h, wd, c)
    qkv = _lin(w, f"{name}.qkv", x, prec).reshape(b, h, wd, 3, c).permute(
        3, 0, 4, 1, 2)
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    q_windows = window_partition(q, ws).view(-1, ws * ws, c)
    kv_windows = F.unfold(kv, kernel_size=(ows, ows), stride=ws,
                          padding=(ows - ws) // 2)
    # 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
    nw = kv_windows.shape[-1]
    kv_windows = kv_windows.view(b, 2, c, ows * ows, nw).permute(
        1, 0, 4, 3, 2).reshape(2, b * nw, ows * ows, c)
    k_windows, v_windows = kv_windows[0], kv_windows[1]
    b_, nq, _ = q_windows.shape
    n = k_windows.shape[1]
    d = c // heads
    q = q_windows.reshape(b_, nq, heads, d).permute(0, 2, 1, 3) * d ** -0.5
    k = k_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    v = v_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    table = w[f"{name}.relative_position_bias_table"]
    bias = table[rpi_oca(ws, ows).to(x.device).view(-1)].view(
        ws * ws, ows * ows, -1).permute(2, 0, 1).contiguous()
    out = _attention(q, k, v, bias, None, prec)
    out = out.transpose(1, 2).reshape(b_, nq, c)
    x = window_reverse(out.view(-1, ws, ws, c), ws, h, wd).view(b, h * wd, c)
    x = _lin(w, f"{name}.proj", x, prec) + shortcut
    return x + _mlp(w, f"{name}.mlp", _ln(w, f"{name}.norm2", x), prec)


def generator(w: dict, x: torch.Tensor, cfg: dict,
              prec: str = "f32") -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> (B, 3, sH, sW)."""
    ws, s = cfg["window_size"], cfg["scale"]
    _, _, h0, w0 = x.shape
    x = F.pad(x, (0, (-w0) % ws, 0, (-h0) % ws), mode="reflect")
    b, _, h, wd = x.shape
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * cfg["img_range"]
    feat = ops.conv(x, w["conv_first.weight"], w["conv_first.bias"], prec)
    c = feat.shape[1]
    t = _ln(w, "patch_embed.norm", feat.flatten(2).transpose(1, 2))
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        g = f"layers.{i}.residual_group"
        r = t
        for j in range(depth):
            r = hab(w, f"{g}.blocks.{j}", r, (h, wd), heads,
                    0 if j % 2 == 0 else ws // 2, cfg, prec)
        r = ocab(w, f"{g}.overlap_attn", r, (h, wd), heads, cfg, prec)
        r = r.transpose(1, 2).view(b, c, h, wd)
        r = ops.conv(r, w[f"layers.{i}.conv.weight"],
                     w[f"layers.{i}.conv.bias"], prec)
        t = r.flatten(2).transpose(1, 2) + t
    t = _ln(w, "norm", t).transpose(1, 2).view(b, c, h, wd)
    t = ops.conv(t, w["conv_after_body.weight"], w["conv_after_body.bias"],
                 prec) + feat
    t = F.leaky_relu(ops.conv(t, w["conv_before_upsample.0.weight"],
                              w["conv_before_upsample.0.bias"], prec), 0.01)
    for k in range(int(math.log2(s))):
        t = ops.pixel_shuffle2(ops.conv(t, w[f"upsample.{2 * k}.weight"],
                                        w[f"upsample.{2 * k}.bias"], prec))
    out = ops.conv(t, w["conv_last.weight"], w["conv_last.bias"], prec)
    out = out / cfg["img_range"] + mean
    return out[:, :, :h0 * s, :w0 * s]


__all__ = ["generator_specs", "generator", "rpi_sa", "rpi_oca",
           "calculate_mask"]
