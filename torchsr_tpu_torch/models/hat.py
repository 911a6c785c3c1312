"""HAT, the Hybrid Attention Transformer (Chen et al., "Activating More
Pixels in Image Super-Resolution Transformer", CVPR, 2023,
arXiv:2205.04437), on NHWC tensors.

The equations are ``hat/archs/hat_arch.py``'s (XPixelGroup/HAT), with
its ``upsampler="pixelshuffle"``, ``resi_connection="1conv"``,
``patch_norm=True``, no absolute position embedding and no dropout
(what its test configurations run):

  x = (x - mean) * img_range,  mean (0.4488, 0.4371, 0.4040)
  feat = conv_first(x)                                  3x3, 3 -> C
  t = LN(feat)                                          patch_embed.norm
  t = RHAG_i(t), i < len(depths):  t + conv3x3(OCAB(HAB_depth(...HAB_1(t))))
  t = conv_after_body(LN(t)) + feat
  t = LeakyReLU_0.01(conv_before_upsample(t))           3x3, C -> 64
  t = log2(scale) x [conv3x3(64 -> 256), PixelShuffle(2)]
  out = conv_last(t) / img_range + mean                 3x3, 64 -> 3

  HAB:  n = LN1(x);  c = CA(conv(GELU(conv(n))))   (C -> C/3 -> C, 3x3;
        CA: n' * sigmoid(conv1x1(ReLU(conv1x1(avgpool(n'))))), C -> C/30
        -> C, the pool over the whole map)
        a = proj(window_attn(qkv(n)))   (shifted by window/2 on odd blocks)
        x = x + a + conv_scale * c;  x = x + MLP(LN2(x))
  OCAB: x = x + proj(overlap_attn(qkv(LN1(x))));  x = x + MLP(LN2(x))
  MLP:  fc2(GELU(fc1(.))), C -> mlp_ratio C -> C, exact GELU

The two attentions are ``ops/window_attn.py``'s (the hand-written kernel
on CUDA, ``hat_arch.py``'s composition on the CPU).  A map whose sides
are not multiples of the window is reflect-padded at its bottom and
right to the next multiple and the output cropped, as HAT's
``pre_process`` / ``post_process`` do (counted in
``window_attn.HAT_PAD_PX``).  The channel-attention pool spans the whole
(padded) map, so a tiled image's output depends on its tiles.

Activations are in ``compute_dtype`` (bf16 under AMP on CUDA, f32 on the
CPU), parameters in f32; LayerNorm's statistics, the channel-attention
gate and the softmax run in f32.  ``state_dict`` keys are
``hat_arch.py``'s (``conv_first``, ``patch_embed.norm``,
``layers.{i}.residual_group.blocks.{j}.{norm1, attn.qkv,
attn.relative_position_bias_table, attn.proj, conv_block.cab.{0, 2},
conv_block.cab.3.attention.{1, 3}, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.residual_group.overlap_attn.{norm1, qkv,
relative_position_bias_table, proj, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.conv``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``, ``upsample.{0, 2}``, ``conv_last``), and the
two index buffers ``relative_position_index_SA`` / ``_OCA`` are written
and read as ``hat_arch.py`` has them (a loaded pair must equal the
computed one), so a published ``HAT_SRx4*.pth`` (``params_ema``, then
``params``) loads as it is.

Nothing is built per map shape: the kernel works out the shift mask
from the tokens' regions and gathers the bias from the table itself; the
plain attention's indices and mask are cached on first use (CPU only);
the kernel's library loads on its first launch, which a graphed caller's
eager warm-up makes before the capture.  The RGB mean is a buffer
outside the ``state_dict``, as ``hat_arch.py`` keeps it outside.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from torchsr_tpu_torch.models.layers import Conv, Dense, _draw
from torchsr_tpu_torch.ops import window_attn as wa
from torchsr_tpu_torch.ops.pixel_shuffle import depth_to_space

RGB_MEAN = (0.4488, 0.4371, 0.4040)
NUM_FEAT = 64


def _trunc_normal(param: torch.Tensor, std: float, generator) -> None:
    """``trunc_normal_(std=std)`` (cut at +-2, absolute, as timm's)."""
    _draw(param, lambda t, g: t.normal_(0.0, std, generator=g).clamp_(
        -2.0, 2.0), generator)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` (eps 1e-5) over the last axis, statistics in f32,
    the result in the input's dtype."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype or torch.float32}
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-5).to(x.dtype)


class Mlp(nn.Module):
    """fc1, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device, dtype=dtype)
        self.fc2 = Dense(hidden, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ChannelAttention(nn.Module):
    """``attention``: avgpool, conv1x1(C -> C/s), ReLU, conv1x1(C/s ->
    C), sigmoid; ``x`` times the gate.  The gate is computed in f32 from
    the pooled map (its 1x1 convs are ``attention.1`` / ``attention.3``)."""

    def __init__(self, dim: int, squeeze: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention = nn.ModuleDict({
            "1": Conv(dim, dim // squeeze, 1, **kw),
            "3": Conv(dim // squeeze, dim, 1, **kw)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.float().mean((1, 2))
        a, b = self.attention["1"], self.attention["3"]
        y = F.relu(F.linear(pooled, a.weight.flatten(1), a.bias))
        y = torch.sigmoid(F.linear(y, b.weight.flatten(1), b.bias))
        return x * y.to(x.dtype)[:, None, None, :]


class CAB(nn.Module):
    """``conv_block``: ``cab`` = conv3x3(C -> C/r), GELU, conv3x3(C/r ->
    C), channel attention."""

    def __init__(self, dim: int, compress: int, squeeze: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cab = nn.ModuleDict({
            "0": Conv(dim, dim // compress, 3, **kw),
            "2": Conv(dim // compress, dim, 3, **kw),
            "3": ChannelAttention(dim, squeeze, **kw)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cab["2"](F.gelu(self.cab["0"](x)))
        return self.cab["3"](y)


class WindowAttention(nn.Module):
    """``attn``: qkv (with bias), the relative-position bias table
    ((2 ws - 1)^2, heads), proj."""

    def __init__(self, dim: int, heads: int, window: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window - 1) ** 2, heads, device=device,
            dtype=dtype or torch.float32))
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.proj = Dense(dim, dim, **kw)


class HAB(nn.Module):
    """The hybrid attention block (module docstring)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 compress: int, squeeze: int, conv_scale: float,
                 mlp_ratio: float, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.shift, self.conv_scale = shift, conv_scale
        self.norm1 = LayerNorm(dim, **kw)
        self.attn = WindowAttention(dim, heads, window, **kw)
        self.conv_block = CAB(dim, compress, squeeze, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm1(x)
        conv = self.conv_block(n)
        attn = self.attn
        a = wa.window_attn(attn.qkv(n), attn.relative_position_bias_table,
                           heads=attn.heads, window=attn.window,
                           shift=self.shift)
        x = x + attn.proj(a) + conv * self.conv_scale
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    """The overlapping cross-attention block (module docstring)."""

    def __init__(self, dim: int, heads: int, window: int, overlap: int,
                 mlp_ratio: float, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.window, self.overlap = heads, window, overlap
        self.norm1 = LayerNorm(dim, **kw)
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (window + overlap - 1) ** 2, heads, device=device,
            dtype=dtype or torch.float32))
        self.proj = Dense(dim, dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = wa.overlap_attn(self.qkv(self.norm1(x)),
                            self.relative_position_bias_table,
                            heads=self.heads, window=self.window,
                            overlap=self.overlap)
        x = x + self.proj(a)
        return x + self.mlp(self.norm2(x))


class AttenBlocks(nn.Module):
    """``residual_group``: ``blocks`` (HABs, shifted on odd ones) then
    ``overlap_attn``."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 overlap: int, compress: int, squeeze: int,
                 conv_scale: float, mlp_ratio: float, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.blocks = nn.ModuleList([
            HAB(dim, heads, window, 0 if i % 2 == 0 else window // 2,
                compress, squeeze, conv_scale, mlp_ratio, **kw)
            for i in range(depth)])
        self.overlap_attn = OCAB(dim, heads, window, overlap, mlp_ratio,
                                 **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.overlap_attn(x)


class RHAG(nn.Module):
    """A residual hybrid attention group: ``x + conv(residual_group(x))``."""

    def __init__(self, dim: int, depth: int, heads: int, *, device=None,
                 dtype=None, **block):
        super().__init__()
        self.residual_group = AttenBlocks(dim, depth, heads, device=device,
                                          dtype=dtype, **block)
        self.conv = Conv(dim, dim, 3, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(self.residual_group(x))


class _Norm(nn.Module):
    """``patch_embed``: its ``norm`` alone (``patch_size`` 1)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.norm = LayerNorm(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class HATGenerator(nn.Module):
    """HAT with the pixel-shuffle upsampler; NHWC in/out, [0, 1] pixel
    space; (B, H, W, 3) -> (B, sH, sW, 3) float32.

    The defaults are HAT_SRx4's (``options/test/
    HAT_SRx4_ImageNet-pretrain.yml``).  ``compute_dtype`` is the
    activation dtype (None = f32), ``generator`` seeds HAT's
    initialization (``_init_weights``: linear layers and the bias tables
    truncated normal, std 0.02, linear biases 0, LayerNorm 1 and 0;
    convolutions PyTorch's default draw)."""

    def __init__(self, scale_factor: int = 4, embed_dim: int = 180,
                 depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6),
                 window_size: int = 16, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0,
                 img_range: float = 1.0, *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        n_up = int(math.log2(scale_factor))
        if 2 ** n_up != scale_factor:
            raise ValueError(f"HAT's pixel-shuffle upsampler takes a power "
                             f"of two, got scale {scale_factor}")
        if len(depths) != len(num_heads):
            raise ValueError("depths and num_heads differ in length")
        kw = {"device": device, "dtype": dtype}
        self.scale_factor = scale_factor
        self.compute_dtype = compute_dtype
        self.window_size = window_size
        self.overlap_size = int(overlap_ratio * window_size) + window_size
        self.img_range = img_range
        self.embed_dim = embed_dim
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.conv_first = Conv(3, embed_dim, 3, **kw)
        self.patch_embed = _Norm(embed_dim, **kw)
        self.layers = nn.ModuleList([
            RHAG(embed_dim, d, h, window=window_size,
                 overlap=self.overlap_size, compress=compress_ratio,
                 squeeze=squeeze_factor, conv_scale=conv_scale,
                 mlp_ratio=mlp_ratio, **kw)
            for d, h in zip(depths, num_heads)])
        self.norm = LayerNorm(embed_dim, **kw)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3, **kw)
        self.conv_before_upsample = nn.ModuleDict(
            {"0": Conv(embed_dim, NUM_FEAT, 3, **kw)})
        self.upsample = nn.ModuleDict(
            {str(2 * k): Conv(NUM_FEAT, 4 * NUM_FEAT, 3, **kw)
             for k in range(n_up)})
        self.conv_last = Conv(NUM_FEAT, 3, 3, **kw)
        # not on the meta device, where an assign-load of a checkpoint
        # (which holds no mean) would leave it without data
        on = None if torch.device(device or "cpu").type == "meta" else device
        self.register_buffer("rgb_mean", torch.tensor(
            RGB_MEAN, device=on, dtype=torch.float32), persistent=False)
        self._register_state_dict_hook(_add_indices)
        self._register_load_state_dict_pre_hook(_check_indices,
                                                with_module=True)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)
            elif isinstance(m, Dense):
                _trunc_normal(m.weight, 0.02, generator)
                _draw(m.bias, lambda t, g: t.zero_(), generator)
            elif isinstance(m, LayerNorm):
                _draw(m.weight, lambda t, g: t.fill_(1.0), generator)
                _draw(m.bias, lambda t, g: t.zero_(), generator)
            elif isinstance(m, (WindowAttention, OCAB)):
                _trunc_normal(m.relative_position_bias_table, 0.02,
                              generator)

    @classmethod
    def sized_to(cls, state: dict, **kw) -> "HATGenerator":
        """A generator with the depths, widths, heads, window, ratios and
        scale of a ``hat_arch.py`` ``state_dict``."""
        groups = sorted({int(k.split(".")[1]) for k in state
                         if k.startswith("layers.")})
        if not groups:
            raise ValueError("not a HAT state_dict: no layers.{i} keys")
        depths = tuple(len({k.split(".")[4] for k in state
                            if k.startswith(f"layers.{i}.residual_group."
                                            f"blocks.")}) for i in groups)
        b = "layers.0.residual_group.blocks.0"
        table = state[f"{b}.attn.relative_position_bias_table"]
        window = (math.isqrt(table.shape[0]) + 1) // 2
        oca = state["layers.0.residual_group.overlap_attn."
                    "relative_position_bias_table"]
        overlap = math.isqrt(oca.shape[0]) + 1 - window
        dim = state["conv_first.weight"].shape[0]
        heads = tuple(
            state[f"layers.{i}.residual_group.blocks.0.attn."
                  f"relative_position_bias_table"].shape[1] for i in groups)
        n_up = len([k for k in state
                    if k.startswith("upsample.") and k.endswith(".weight")])
        return cls(
            scale_factor=2 ** n_up, embed_dim=dim, depths=depths,
            num_heads=heads, window_size=window,
            compress_ratio=dim // state[f"{b}.conv_block.cab.0.weight"]
            .shape[0],
            squeeze_factor=dim // state[
                f"{b}.conv_block.cab.3.attention.1.weight"].shape[0],
            overlap_ratio=(overlap - window) / window,
            mlp_ratio=state[f"{b}.mlp.fc1.weight"].shape[0] / dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, sH, sW, 3) float32."""
        b, h, w, _ = x.shape
        ws = self.window_size
        ph, pw = h + (-h) % ws, w + (-w) % ws
        x = x.float()
        if (ph, pw) != (h, w):
            # HAT's pre_process: reflect at the bottom and right
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw - w, 0, ph - h),
                      mode="reflect").permute(0, 2, 3, 1)
            wa.count_pad(b * (ph * pw - h * w))
        mean = self.rgb_mean
        x = ((x - mean) * self.img_range).to(self.compute_dtype or
                                              torch.float32)
        feat = self.conv_first(x)
        t = self.patch_embed(feat)
        for layer in self.layers:
            t = layer(t)
        t = self.conv_after_body(self.norm(t)) + feat
        t = F.leaky_relu(self.conv_before_upsample["0"](t), 0.01)
        for k in range(len(self.upsample)):
            t = depth_to_space(self.upsample[str(2 * k)](t), 2)
        out = self.conv_last(t).float() / self.img_range + mean
        s = self.scale_factor
        return out[:, :h * s, :w * s]


def _add_indices(module, state: dict, prefix: str, _meta) -> None:
    """``hat_arch.py`` keeps the two relative-position indices as
    buffers: write them where it does."""
    state[f"{prefix}relative_position_index_SA"] = wa.sa_index(
        module.window_size).clone()
    state[f"{prefix}relative_position_index_OCA"] = wa.oca_index(
        module.window_size, module.overlap_size).clone()


def _check_indices(module, state: dict, prefix: str, *_args) -> None:
    """Take the two index buffers out of a loaded ``state_dict``; a pair
    that differs from the computed one raises (another formula would
    gather other biases)."""
    for key, want in (
            ("relative_position_index_SA", wa.sa_index(module.window_size)),
            ("relative_position_index_OCA",
             wa.oca_index(module.window_size, module.overlap_size))):
        got = state.pop(prefix + key, None)
        if got is not None and not torch.equal(
                got.to("cpu", torch.int64), want):
            raise ValueError(f"{key} of the state_dict differs from "
                             f"hat_arch.py's formula")
