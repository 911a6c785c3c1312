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

The public RRDBNet naming schemes (xinntao, BasicSR) are not mapped
yet (ROADMAP A10).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


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
    params tree itself) as numpy arrays."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
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


def _refuse_scan(params: Mapping[str, Any]) -> None:
    if "blocks_scan" in params:
        raise ValueError(
            "stacked nn.scan parameters (blocks_scan) are not supported; "
            "unstack them to block{i} with the JAX package's "
            "models.scan_compat first"
        )


def _srgan_generator_from_jax(params: Mapping[str, Any],
                              stats: Mapping[str, Any]) -> dict:
    """The SRGAN generator: ``conv1``, ``prelu1``, ``block{i}/{conv1,
    bn1, prelu, conv2, bn2}``, ``conv2``, ``bn2``,
    ``upsample{i}/{conv, prelu}`` and the head ``conv3`` (the fused
    ``SubpixelSpaceConv``'s ``conv3/conv/{kernel,bias}``, a plain conv's
    tree), under the reference's keys."""
    _refuse_scan(params)
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
    _refuse_scan(params)
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
