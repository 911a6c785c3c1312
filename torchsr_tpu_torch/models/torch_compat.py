"""State-dict interop: reference ``.pth`` layouts and JAX parameters.

The port's generator uses the reference's module names, so a reference
``state_dict`` needs only its wrappers taken off (``strip_ddp_prefix``,
``unwrap_state_dict``).  ``from_jax_variables`` carries the JAX
package's flax parameters across: conv kernels go from HWIO to OIHW and
the flax tree names map to the reference's keys, the same mapping as
``torchsr_tpu.models.torch_compat.export_esrgan_generator``.

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
    sd[f"{prefix}.bias"] = _t(conv["bias"])


def _index(name: str, stem: str) -> int:
    return int(name[len(stem):])


def from_jax_variables(variables: Mapping[str, Any]) -> dict:
    """JAX ESRGAN generator variables -> the port's ``state_dict``.

    ``variables``: ``{"params": {...}}`` (or the params tree itself) as
    numpy arrays: ``conv1/conv/{kernel,bias}``,
    ``block{i}/rdb{j}/conv{c}/conv/...``, ``conv2``, ``upsample{k}``,
    ``conv3``, ``conv4``.  Returns f32 CPU tensors under the reference's
    keys."""
    params = variables.get("params", variables)
    if "blocks_scan" in params:
        raise ValueError(
            "stacked nn.scan parameters (blocks_scan) are not supported; "
            "unstack them to block{i} with the JAX package's "
            "models.scan_compat first"
        )
    sd: dict = {}
    _conv(params["conv1"], "conv1", sd)
    blocks = sorted((k for k in params if k.startswith("block")),
                    key=lambda k: _index(k, "block"))
    for i, key in enumerate(blocks):
        for j in range(1, 4):
            rdb = params[key][f"rdb{j}"]
            for c in range(1, 5):
                _conv(rdb[f"conv{c}"], f"blocks.{i}.RDB{j}.conv{c}.0", sd)
            _conv(rdb["conv5"], f"blocks.{i}.RDB{j}.conv5", sd)
    _conv(params["conv2"], "conv2", sd)
    ups = sorted((k for k in params if k.startswith("upsample")),
                 key=lambda k: _index(k, "upsample"))
    for key in ups:
        _conv(params[key], key, sd)
    _conv(params["conv3"], "conv3.0", sd)
    _conv(params["conv4"], "conv4", sd)
    return sd
