"""Operations and bytes of the work the cells run, from shapes alone.

Model FLOPs count the convolutions' and dense layers' multiply-adds
(2 FLOPs each), forward and backward as a step runs them (a gradient
with respect to a layer's input only where something upstream needs
it, with respect to its weights only where they train), and nothing
else: no bias, activation, norm, loss or optimizer arithmetic, no
recompute, and for tiled serving no tile overlap (a frame counts as one
whole-image forward of its LR pixels).

The RDB kernels' bounds (B1 the forward, B2 the backward of one
residual dense block on (B, H, W, 64) bf16 activations) are the larger
of their FLOPs over the peak and their least bytes (each input read
once, each output written once) over the memory bandwidth.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16,
3.35 TB/s HBM3, at the card's full 700 W.
"""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


# ------------------------------------------------------------ layers
# A layer is (c_in, c_out, k, out_pixels): a k x k conv (k = 0: dense,
# out_pixels 1) and how many output pixels it makes per unit of input
# (an LR pixel for a generator, an image for a discriminator or VGG).


def rdb_macs_per_pixel(nf: int = 64, gc: int = 32, convs: int = 5) -> int:
    """Multiply-adds of one residual dense block per pixel."""
    cin = [nf + i * gc for i in range(convs)]
    cout = [gc] * (convs - 1) + [nf]
    return sum(9 * a * b for a, b in zip(cin, cout))


def esrgan_generator_layers(cfg: dict) -> list:
    nf, gc, n = cfg["nf"], cfg["gc"], cfg["convs_per_rdb"]
    layers = [(3, nf, 3, 1)]
    cin = [nf + i * gc for i in range(n)]
    cout = [gc] * (n - 1) + [nf]
    for _ in range(cfg["num_rrdb"] * cfg["rdbs_per_rrdb"]):
        layers += [(a, b, 3, 1) for a, b in zip(cin, cout)]
    layers.append((nf, nf, 3, 1))
    stages = int(math.log2(cfg["scale"]))
    layers += [(nf, nf, 3, 4 ** (k + 1)) for k in range(stages)]
    px = cfg["scale"] ** 2
    return layers + [(nf, nf, 3, px), (nf, 3, 3, px)]


def srgan_generator_layers(cfg: dict) -> list:
    nf = cfg["nf"]
    layers = [(3, nf, 9, 1)]
    layers += [(nf, nf, 3, 1)] * (2 * cfg["num_residual"] + 1)
    stages = int(math.log2(cfg["scale"]))
    layers += [(nf, 4 * nf, 3, 4 ** k) for k in range(stages)]
    return layers + [(nf, 3, 9, cfg["scale"] ** 2)]


def generator_layers(cfg: dict) -> list:
    return {"esrgan": esrgan_generator_layers,
            "srgan": srgan_generator_layers}[cfg["family"]](cfg)


def discriminator_layers(cfg: dict, size: int) -> list:
    d, layers, c_in, s = cfg["disc"], [], 3, size
    for c_out, stride, _bn in d["stages"]:
        s //= stride
        layers.append((c_in, c_out, 3, s * s))
        c_in = c_out
    layers.append((c_in * s * s, d["dense"], 0, 1))
    return layers + [(d["dense"], 1, 0, 1)]


def vgg_layers(cfg: dict, size: int, max_convs: int | None = None) -> list:
    layers, c_in, s = [], 3, size
    for item in cfg["vgg"]["layers"]:
        if max_convs is not None and len(layers) >= max_convs:
            break
        if item == "M":
            s //= 2
            continue
        layers.append((c_in, item, 3, s * s))
        c_in = item
    return layers


def macs(layers: list, skip_first: bool = False) -> int:
    """Multiply-adds of ``layers`` (of all but the first with
    ``skip_first``)."""
    return sum((k * k if k else 1) * a * b * px
               for a, b, k, px in layers[1 if skip_first else 0:])


# ------------------------------------------------------------ model FLOPs


def generator_flops_per_lr_pixel(cfg: dict) -> float:
    """FLOPs of one generator forward per LR pixel."""
    return 2.0 * macs(generator_layers(cfg))


def step_flops(cfg: dict, phase: str, batch: int, crop: int,
               vgg_convs: int | None = None) -> float:
    """Model FLOPs of one training step on ``batch`` crops of ``crop``
    HR pixels (module docstring).  ``pretrain``: the generator forward
    and backward.  ``gan``: the generator forward; the discriminator
    forward on hr and on the detached sr and its backward (weights, and
    inputs past the first layer); VGG forward on hr and sr and its
    backward into sr; the discriminator forward on hr and sr for the
    generator's loss and its backward into sr (inputs only: it does not
    train then); the generator's backward."""
    lr_px = (crop // cfg["scale"]) ** 2
    gen = generator_layers(cfg)
    g_fwd = macs(gen) * lr_px
    g_bwd = (macs(gen) + macs(gen, skip_first=True)) * lr_px
    total = g_fwd + g_bwd
    if phase == "gan":
        d = discriminator_layers(cfg, crop)
        v = vgg_layers(cfg, crop, vgg_convs)
        d_fwd = macs(d)
        total += 4 * d_fwd                              # D(hr), D(sr) twice
        total += 2 * (macs(d) + macs(d, skip_first=True))  # disc update
        total += macs(d)                                # into sr
        total += 2 * macs(v) + macs(v)                  # VGG fwd x2, into sr
    return 2.0 * total * batch


# ------------------------------------------------------------ RDB bounds


def rdb_fwd_cost(b: int, h: int, w: int, nf: int = 64, gc: int = 32,
                 convs: int = 5, itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of B1 on (b, h, w, nf): x read, the block's output
    written, the five kernels and biases read."""
    px = b * h * w
    flops = 2.0 * rdb_macs_per_pixel(nf, gc, convs) * px
    wbytes = rdb_macs_per_pixel(nf, gc, convs) * itemsize
    return flops, 2.0 * px * nf * itemsize + wbytes


def rdb_bwd_cost(b: int, h: int, w: int, nf: int = 64, gc: int = 32,
                 convs: int = 5, itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of B2 on (b, h, w, nf): the gradients with respect
    to the input (dgrad) and the kernels (wgrad), each the forward's
    multiply-adds; the saved features (nf + (convs - 1) gc channels) and
    the output gradient read, the input gradient written, the kernels'
    gradients in f32 written."""
    px = b * h * w
    m = rdb_macs_per_pixel(nf, gc, convs)
    saved = nf + (convs - 1) * gc
    return 4.0 * m * px, px * (saved + 2 * nf) * itemsize + 4.0 * m


def bound_ms(flops: float, nbytes: float) -> float:
    return 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
