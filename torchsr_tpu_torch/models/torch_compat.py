"""State-dict interop: reference ``.pth`` layouts and JAX parameters.

The port's networks use the reference's module names, so a reference
``state_dict`` needs only its wrappers taken off (``strip_ddp_prefix``,
``unwrap_state_dict``).  ``from_jax_variables`` carries the JAX
package's flax variables across, for the ESRGAN and SRGAN generators
and discriminators (parameters and BatchNorm statistics) and the VGG19
trunk: conv kernels go from HWIO to OIHW, dense kernels from (in, out)
to (out, in), and the flax tree names map to the reference's (or
torchvision's) keys, the mapping of the JAX package's
``torchsr_tpu.models.torch_compat`` converters run backwards.

The one layout trap: the JAX discriminator's ``fc1`` consumes its final
feature map flattened in HWC order (NHWC ``reshape``), the reference's
``classifier.0`` in CHW order (``torch.flatten`` of NCHW).  The port
keeps the reference's layout, so ``fc1``'s input axis is permuted from
HWC to CHW on the way across.

A stacked ``blocks_scan`` tree (the JAX package's ``--fast-compile``
layout) is unrolled first (``models/scan_compat.py``), and
``from_jax_training_state`` carries a JAX training checkpoint's extras
(discriminator, the three optax Adam states, step, best PSNR) across.

ESRGAN also comes in the three public RRDBNet naming schemes, the same
graph under other module names, which ``canonical_esrgan_sd`` maps onto
the reference's (and ``externalize_esrgan_sd`` back out), as the JAX
package's ``_canonical_esrgan_sd`` and ``externalize_esrgan_sd`` do:

  * xinntao old-arch (``RRDB_ESRGAN_x4.pth``, 4x only): ``model.0``,
    ``model.1.sub.{i}.RDB{j}.conv{c}.0``, ``model.1.sub.{N}`` (trunk),
    ``model.{3,6,8,10}``;
  * xinntao new-arch (``RRDBNet``): ``conv_first``,
    ``RRDB_trunk.{i}.RDB{j}.conv{c}``, ``trunk_conv``, ``upconv1/2``,
    ``HRconv``, ``conv_last``;
  * BasicSR / Real-ESRGAN: ``conv_first``, ``body.{i}.rdb{j}.conv{c}``,
    ``conv_body``, ``conv_up1/2``, ``conv_hr``, ``conv_last``, wrapped
    in ``params_ema`` / ``params`` (``unwrap_state_dict``).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from torchsr_tpu_torch.models.scan_compat import unroll_blocks


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> dict:
    """Remove DDP's ``module.`` prefix from every key; keys without it
    pass through unchanged."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        out[key] = value
    return out


def unwrap_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """Take off the ``{"params_ema"}`` / ``{"params"}`` wrapper of
    BasicSR / Real-ESRGAN releases (EMA preferred) and DDP's prefix."""
    for wrapper in ("params_ema", "params"):
        inner = state_dict.get(wrapper)
        if isinstance(inner, Mapping) and inner:
            state_dict = inner
            break
    return strip_ddp_prefix(state_dict)


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def _conv(node: Mapping[str, Any], prefix: str, sd: dict) -> None:
    conv = node["conv"]
    sd[f"{prefix}.weight"] = _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        sd[f"{prefix}.bias"] = _t(conv["bias"])


def _index(name: str, stem: str) -> int:
    return int(name[len(stem):])


def from_jax_variables(variables: Mapping[str, Any]) -> dict:
    """JAX variables of an ESRGAN or SRGAN generator or discriminator,
    or of the VGG19 trunk -> the port's ``state_dict`` (f32 CPU tensors;
    BatchNorms' ``num_batches_tracked`` 0, a leaf the JAX tree lacks),
    told apart by their tree: a discriminator has ``fc1`` (eight conv
    stages for SRGAN, ten for ESRGAN), the SRGAN generator ``prelu1``,
    the ESRGAN generator ``block{i}``/``upsample{k}``, the VGG19 trunk
    only ``conv{i}``.

    ``variables``: ``{"params": {...}, "batch_stats": {...}}`` (or the
    params tree itself) as numpy arrays, the generator's tower unrolled
    (``block{i}``) or stacked (``blocks_scan``)."""
    params = unroll_blocks(variables.get("params", variables))
    stats = unroll_blocks(variables.get("batch_stats", {}))
    if "fc1" in params:
        return _discriminator_from_jax(params, stats)
    if "prelu1" in params:
        return _srgan_generator_from_jax(params, stats)
    if not any(k.startswith(("block", "upsample")) for k in params):
        return _vgg19_from_jax(params)
    return _generator_from_jax(params)


def _bn(params: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
        sd: dict) -> None:
    """One JAX ``BatchNorm`` (``bn/{scale,bias}``, statistics
    ``bn/{mean,var}``) under ``nn.BatchNorm2d``'s keys."""
    bn, st = params["bn"], stats["bn"]
    sd[f"{prefix}.weight"] = _t(bn["scale"])
    sd[f"{prefix}.bias"] = _t(bn["bias"])
    sd[f"{prefix}.running_mean"] = _t(st["mean"])
    sd[f"{prefix}.running_var"] = _t(st["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _sorted_keys(params: Mapping[str, Any], stem: str) -> list:
    return sorted((k for k in params
                   if k.startswith(stem) and k[len(stem):].isdigit()),
                  key=lambda k: _index(k, stem))


def _srgan_generator_from_jax(params: Mapping[str, Any],
                              stats: Mapping[str, Any]) -> dict:
    """The SRGAN generator: ``conv1``, ``prelu1``, ``block{i}/{conv1,
    bn1, prelu, conv2, bn2}``, ``conv2``, ``bn2``,
    ``upsample{i}/{conv, prelu}`` and the head ``conv3`` (the fused
    ``SubpixelSpaceConv``'s ``conv3/conv/{kernel,bias}``, a plain conv's
    tree), under the reference's keys."""
    sd: dict = {}
    _conv(params["conv1"], "conv1.0", sd)
    sd["conv1.1.weight"] = _t(params["prelu1"]["alpha"])
    for i, key in enumerate(_sorted_keys(params, "block")):
        bp, bs, p = params[key], stats[key], f"blocks.{i}"
        _conv(bp["conv1"], f"{p}.conv1", sd)
        _bn(bp["bn1"], bs["bn1"], f"{p}.bn1", sd)
        sd[f"{p}.prelu.weight"] = _t(bp["prelu"]["alpha"])
        _conv(bp["conv2"], f"{p}.conv2", sd)
        _bn(bp["bn2"], bs["bn2"], f"{p}.bn2", sd)
    _conv(params["conv2"], "conv2.0", sd)
    _bn(params["bn2"], stats["bn2"], "conv2.1", sd)
    for i, key in enumerate(_sorted_keys(params, "upsample")):
        _conv(params[key]["conv"], f"conv_layers.{i}.conv", sd)
        sd[f"conv_layers.{i}.prelu.weight"] = _t(
            params[key]["prelu"]["alpha"])
    _conv(params["conv3"], "conv3", sd)
    return sd


def _generator_from_jax(params: Mapping[str, Any]) -> dict:
    """The ESRGAN generator: ``conv1/conv/{kernel,bias}``,
    ``block{i}/rdb{j}/conv{c}/conv/...``, ``conv2``, ``upsample{k}``,
    ``conv3``, ``conv4``, under the reference's keys."""
    sd: dict = {}
    _conv(params["conv1"], "conv1", sd)
    for i, key in enumerate(_sorted_keys(params, "block")):
        for j in range(1, 4):
            rdb = params[key][f"rdb{j}"]
            for c in range(1, 5):
                _conv(rdb[f"conv{c}"], f"blocks.{i}.RDB{j}.conv{c}.0", sd)
            _conv(rdb["conv5"], f"blocks.{i}.RDB{j}.conv5", sd)
    _conv(params["conv2"], "conv2", sd)
    for key in _sorted_keys(params, "upsample"):
        _conv(params[key], key, sd)
    _conv(params["conv3"], "conv3.0", sd)
    _conv(params["conv4"], "conv4", sd)
    return sd


# torchvision's indices of the 16 convs of VGG19 features[:36]
_VGG19_CONVS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def _discriminator_from_jax(params: Mapping[str, Any],
                            stats: Mapping[str, Any]) -> dict:
    """Either discriminator: ``conv{i}`` stages with ``bn{i}`` on all
    but the first, then ``fc1``/``fc2``.  In the reference's
    ``features`` Sequential stage 0 is conv, LeakyReLU and stage i > 0
    conv, BatchNorm, LeakyReLU, so conv i sits at 3i - 1 (0 for the
    first) and BatchNorm i at 3i."""
    sd: dict = {}
    for i in range(len(_sorted_keys(params, "conv"))):
        _conv(params[f"conv{i}"], f"features.{max(3 * i - 1, 0)}", sd)
        if i:
            _bn(params[f"bn{i}"], stats[f"bn{i}"], f"features.{3 * i}", sd)
    # fc1: (h * w * 512, n) over the HWC flattening -> (n, 512 * h * w)
    # over the CHW flattening
    kernel = np.asarray(params["fc1"]["dense"]["kernel"])
    fm = int(round((kernel.shape[0] // 512) ** 0.5))
    sd["classifier.0.weight"] = _t(
        kernel.T.reshape(-1, fm, fm, 512).transpose(0, 3, 1, 2)
        .reshape(kernel.shape[1], -1))
    sd["classifier.0.bias"] = _t(params["fc1"]["dense"]["bias"])
    sd["classifier.2.weight"] = _t(
        np.asarray(params["fc2"]["dense"]["kernel"]).T)
    sd["classifier.2.bias"] = _t(params["fc2"]["dense"]["bias"])
    return sd


def _vgg19_from_jax(params: Mapping[str, Any]) -> dict:
    sd: dict = {}
    n = len([k for k in params if k.startswith("conv")])
    for i in range(n):
        _conv(params[f"conv{i}"], f"features.{_VGG19_CONVS[i]}", sd)
    return sd


_STAT_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def _moments(tree: Mapping[str, Any], stats: Mapping[str, Any]) -> dict:
    """An optax moment tree (the parameters' layout) -> ``{parameter
    name: tensor}``; ``stats`` fill the BatchNorm statistics the
    conversion expects and are dropped."""
    sd = from_jax_variables({"params": tree, "batch_stats": stats})
    return {k: v for k, v in sd.items() if not k.endswith(_STAT_SUFFIXES)}


def from_jax_training_state(extra: Mapping[str, Any],
                            gen_stats: Mapping[str, Any]) -> dict:
    """The ``extra`` of a JAX training checkpoint -> the port's
    (``GANTrainer._full_state``'s keys): ``disc_state``, the step and
    best PSNR, and each optax Adam state (``({"count", "mu", "nu"},
    {})``) as ``{"count": int, "exp_avg": {name: tensor}, "exp_avg_sq":
    {name: tensor}}`` by parameter name, which ``train/state.py`` loads
    into the optimizer.  Moments in the stacked layout (a
    ``--fast-compile`` run's) are unrolled.  ``gen_stats``: the
    generator's BatchNorm statistics (SRGAN), as conversion filler."""
    disc_stats = extra.get("disc_stats", {})
    out: dict = {}
    if "disc_params" in extra:
        out["disc_state"] = from_jax_variables(
            {"params": extra["disc_params"], "batch_stats": disc_stats})
    for key, stats in (("psnr_opt_state", gen_stats),
                       ("gen_opt_state", gen_stats),
                       ("disc_opt_state", disc_stats)):
        if key in extra:
            adam = extra[key]["0"]
            out[key] = {"count": int(np.asarray(adam["count"])),
                        "exp_avg": _moments(adam["mu"], stats),
                        "exp_avg_sq": _moments(adam["nu"], stats)}
    if "step" in extra:
        out["step"] = int(np.asarray(extra["step"]))
    if "best_psnr" in extra:
        out["best_psnr"] = float(np.asarray(extra["best_psnr"]))
    return out


def _rules(pairs) -> list:
    return [(re.compile(p), r) for p, r in pairs]


# xinntao old-arch: only released at 4x; these sequential indices are
# the 4x layout
_OLD_ARCH = _rules((
    (r"^model\.0\.(weight|bias)$", r"conv1.\1"),
    (r"^model\.1\.sub\.(\d+)\.(RDB\d)\.(conv[1-4])\.0\.(weight|bias)$",
     r"blocks.\1.\2.\3.0.\4"),
    (r"^model\.1\.sub\.(\d+)\.(RDB\d)\.conv5\.0\.(weight|bias)$",
     r"blocks.\1.\2.conv5.\3"),
    (r"^model\.1\.sub\.\d+\.(weight|bias)$", r"conv2.\1"),
    (r"^model\.3\.(weight|bias)$", r"upsample1.\1"),
    (r"^model\.6\.(weight|bias)$", r"upsample2.\1"),
    (r"^model\.8\.(weight|bias)$", r"conv3.0.\1"),
    (r"^model\.10\.(weight|bias)$", r"conv4.\1"),
))
_NEW_ARCH = _rules((
    (r"^conv_first\.(weight|bias)$", r"conv1.\1"),
    (r"^RRDB_trunk\.(\d+)\.(RDB\d)\.(conv[1-4])\.(weight|bias)$",
     r"blocks.\1.\2.\3.0.\4"),
    (r"^RRDB_trunk\.(\d+)\.(RDB\d)\.conv5\.(weight|bias)$",
     r"blocks.\1.\2.conv5.\3"),
    (r"^trunk_conv\.(weight|bias)$", r"conv2.\1"),
    (r"^upconv1\.(weight|bias)$", r"upsample1.\1"),
    (r"^upconv2\.(weight|bias)$", r"upsample2.\1"),
    (r"^HRconv\.(weight|bias)$", r"conv3.0.\1"),
    (r"^conv_last\.(weight|bias)$", r"conv4.\1"),
))
_BASICSR = _rules((
    (r"^conv_first\.(weight|bias)$", r"conv1.\1"),
    (r"^body\.(\d+)\.rdb(\d)\.(conv[1-4])\.(weight|bias)$",
     r"blocks.\1.RDB\2.\3.0.\4"),
    (r"^body\.(\d+)\.rdb(\d)\.conv5\.(weight|bias)$",
     r"blocks.\1.RDB\2.conv5.\3"),
    (r"^conv_body\.(weight|bias)$", r"conv2.\1"),
    (r"^conv_up1\.(weight|bias)$", r"upsample1.\1"),
    (r"^conv_up2\.(weight|bias)$", r"upsample2.\1"),
    (r"^conv_hr\.(weight|bias)$", r"conv3.0.\1"),
    (r"^conv_last\.(weight|bias)$", r"conv4.\1"),
))


def is_esrgan_sd(sd: Mapping[str, Any]) -> bool:
    """Whether a generator state_dict is an ESRGAN's, in any scheme:
    its keys name (R)RDB blocks (upper case in the reference's and
    xinntao's, lower case in BasicSR's)."""
    return any("rdb" in k.lower() for k in sd)


def canonical_esrgan_sd(sd: Mapping[str, Any]) -> dict:
    """A public RRDBNet scheme (module docstring) -> the reference's
    keys; a reference-named dict passes through.  A dict the scheme's
    rules do not map whole raises, as do an old-arch dict without
    ``model.10`` (not the 4x layout) and a BasicSR ``conv_first`` that
    takes a pixel-unshuffled input (Real-ESRGAN x1/x2: not this
    generator)."""
    keys = list(sd)
    if any(k.startswith("model.") for k in keys):
        if "model.10.weight" not in sd:
            raise ValueError(
                "old-arch ESRGAN checkpoint without model.10: only the 4x "
                "layout (model.0..model.10) is supported")
        rules = _OLD_ARCH
    elif any(k.startswith("RRDB_trunk.") for k in keys):
        rules = _NEW_ARCH
    elif any(k.startswith("body.") for k in keys):
        w = sd.get("conv_first.weight")
        if w is not None and w.shape[1] != 3:
            raise ValueError(
                "BasicSR RRDBNet with a pixel-unshuffled input (conv_first "
                f"expects {w.shape[1]} channels): these 1x/2x Real-ESRGAN "
                "variants have no counterpart in this generator; only 4x "
                "RGB-input models load")
        rules = _BASICSR
    else:
        return dict(sd)
    out: dict = {}
    unmapped = []
    for key, value in sd.items():
        for pat, repl in rules:
            new, n = pat.subn(repl, key)
            if n:
                out[new] = value
                break
        else:
            unmapped.append(key)
    if unmapped:
        raise ValueError("external ESRGAN checkpoint has keys this converter "
                         f"does not recognize: {sorted(unmapped)[:8]}")
    return out


EXPORT_SCHEMES = ("reference", "rrdbnet", "basicsr")
_EXPORT_HEADS = {
    "rrdbnet": ((r"^blocks\.(\d+)\.(RDB\d)\.(conv\d)(?:\.0)?\.",
                 r"RRDB_trunk.\1.\2.\3."),
                (("conv1.", "conv_first."), ("conv2.", "trunk_conv."),
                 ("upsample1.", "upconv1."), ("upsample2.", "upconv2."),
                 ("conv3.0.", "HRconv."), ("conv4.", "conv_last."))),
    "basicsr": ((r"^blocks\.(\d+)\.RDB(\d)\.(conv\d)(?:\.0)?\.",
                 r"body.\1.rdb\2.\3."),
                (("conv1.", "conv_first."), ("conv2.", "conv_body."),
                 ("upsample1.", "conv_up1."), ("upsample2.", "conv_up2."),
                 ("conv3.0.", "conv_hr."), ("conv4.", "conv_last."))),
}


def externalize_esrgan_sd(sd: Mapping[str, Any], scheme: str) -> dict:
    """A reference-named ESRGAN state_dict -> a public scheme:
    ``"rrdbnet"`` (xinntao new-arch) or ``"basicsr"``; ``"reference"``
    passes through.  A key outside the 4x reference layout raises."""
    if scheme not in EXPORT_SCHEMES:
        raise ValueError(
            f"unknown scheme {scheme!r} (choose from {EXPORT_SCHEMES})")
    if scheme == "reference":
        return dict(sd)
    (block, block_repl), heads = _EXPORT_HEADS[scheme]
    pat = re.compile(block)
    out = {}
    for key, value in sd.items():
        new, n = pat.subn(block_repl, key)
        if not n:
            for prefix, repl in heads:
                if new.startswith(prefix):
                    new = repl + new[len(prefix):]
                    break
            else:
                raise ValueError(
                    f"cannot externalize key {key!r} (not a reference-named "
                    f"ESRGAN generator state_dict)")
        out[new] = value
    return out
