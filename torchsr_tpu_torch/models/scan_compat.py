"""Generator trees between the unrolled and the stacked (``nn.scan``)
layouts.

The port's own copy of ``torchsr_tpu/models/scan_compat.py``, on plain
nested dicts whose leaves are numpy arrays or tensors.  The JAX
package's ``--fast-compile`` runs its generator tower as one
``nn.scan`` block: its parameters, and the optimizer moments that nest
their layout, hold one subtree ``blocks_scan/block/...`` whose leaves
are stacked on a leading axis, where the unrolled tower names its
blocks ``block0..block{N-1}``.  Its checkpoints store the generator
unrolled but the optimizer state as it was, so the port unrolls what it
reads (``from_jax_variables``, the resume from a ``.ckpt``).
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

_BLOCK_RE = re.compile(r"block(\d+)$")


def is_scan_layout(tree) -> bool:
    return "blocks_scan" in tree


def _to_plain(tree):
    if hasattr(tree, "items"):
        return {k: _to_plain(v) for k, v in tree.items()}
    return tree


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts nest)."""
    if hasattr(trees[0], "items"):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree) -> Any:
    while hasattr(tree, "items"):
        tree = next(iter(tree.values()))
    return tree


def _stack(*leaves):
    if hasattr(leaves[0], "detach"):
        import torch

        return torch.stack(leaves)
    return np.stack(leaves)


def unroll_blocks(tree):
    """``blocks_scan/block`` (stacked leaves) -> ``block{i}`` subtrees; a
    tree already unrolled comes back as a plain copy."""
    tree = _to_plain(tree)
    if not is_scan_layout(tree):
        return tree
    stacked = tree.pop("blocks_scan")["block"]
    for i in range(_first_leaf(stacked).shape[0]):
        tree[f"block{i}"] = _map(lambda a, i=i: a[i], stacked)
    return tree


def stack_blocks(tree):
    """``block{i}`` subtrees -> ``blocks_scan/block`` stacked leaves; a
    tree with no ``block{i}`` (a discriminator) or already stacked comes
    back as a plain copy."""
    tree = _to_plain(tree)
    names = sorted((k for k in tree if _BLOCK_RE.fullmatch(str(k))),
                   key=lambda k: int(_BLOCK_RE.fullmatch(str(k)).group(1)))
    if not names:
        return tree
    blocks = [tree.pop(k) for k in names]
    tree["blocks_scan"] = {"block": _map(_stack, *blocks)}
    return tree
