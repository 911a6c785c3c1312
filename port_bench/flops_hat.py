"""Operations and bytes of HAT's work (``configs/hat.json``), from shapes
alone, counted as ``flops.py`` counts: 2 FLOPs a multiply-add of the
convolutions, the dense layers and the two attention products (q . k
and p . v at the heads' own dim, 30 for HAT SRx4), and nothing else (no
bias, LayerNorm, GELU, softmax or gate arithmetic; the channel
attention's two 1x1 convs act on one pooled vector a map and are left
out); for tiled serving no tile overlap: a frame counts as one
whole-image forward of its LR pixels.

The attention kernel's bound (HA, ``kernels/window_attn.json``,
``kernels/overlap_attn.json``) at (B, H, W, C): the two products over
the bf16 peak against q, k and v read once and the output written once
(bf16) over the memory bandwidth, whichever is larger
(``flops.bound_ms``).
"""

from __future__ import annotations

import math

from port_bench import flops


def sizes(cfg: dict) -> dict:
    c, ws = cfg["embed_dim"], cfg["window_size"]
    return {"c": c, "n": ws * ws,
            "m": (ws + int(cfg["overlap_ratio"] * ws)) ** 2,
            "hidden": int(c * cfg["mlp_ratio"]),
            "cab": c // cfg["compress_ratio"]}


def block_macs_per_token(cfg: dict) -> dict:
    """Multiply-adds a token of one HAB and one OCAB."""
    z = sizes(cfg)
    c, hid = z["c"], z["hidden"]
    dense = 3 * c * c + c * c + 2 * c * hid        # qkv, proj, the MLP
    cab = 9 * c * z["cab"] * 2                       # the CAB's two convs
    return {"hab": dense + cab + 2 * z["n"] * c,
            "ocab": dense + 2 * z["m"] * c}


def generator_macs_per_lr_pixel(cfg: dict) -> int:
    c, s = cfg["embed_dim"], cfg["scale"]
    blocks = block_macs_per_token(cfg)
    macs = 9 * 3 * c                                  # conv_first
    for depth in cfg["depths"]:
        macs += depth * blocks["hab"] + blocks["ocab"] + 9 * c * c
    macs += 9 * c * c + 9 * c * 64                   # after body, before up
    macs += sum(9 * 64 * 256 * 4 ** k for k in range(int(math.log2(s))))
    return macs + 9 * 64 * 3 * s * s                 # conv_last


def generator_flops_per_lr_pixel(cfg: dict) -> float:
    """FLOPs of one HAT forward per LR pixel (about 50.7 M for SRx4)."""
    return 2.0 * generator_macs_per_lr_pixel(cfg)


def attn_cost(b: int, h: int, w: int, c: int, keys: int,
              itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention call over (b, h, w) tokens of C
    channels, each query against ``keys`` keys: the two products, and
    q, k, v read and the output written once."""
    tokens = b * h * w
    return 4.0 * tokens * keys * c, tokens * 4.0 * c * itemsize


def attn_bound_ms(cfg: dict, svc: dict, overlap: bool) -> float:
    """The bound of one HAB (or OCAB) call at the cell's tile batch."""
    z = sizes(cfg)
    return flops.bound_ms(*attn_cost(svc["tile_batch"], svc["tile"],
                                     svc["tile"], z["c"],
                                     z["m"] if overlap else z["n"]))
