# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Checkpoint save and restore of param trees (counterpart of
``conch_tpu/utils/checkpoint.py``: ``save_checkpoint``,
``restore_checkpoint``), in the same ``.npz`` + ``.json`` format, so
either package reads what the other wrote, bit for bit.

Leaves are ordered as ``jax.tree_util.tree_flatten`` orders them: dict
keys sorted, lists and tuples in order, ``None`` no leaf, and a
``QuantizedLinear`` gives its ``arrays`` in sorted key order (its
``kind`` and ``meta`` are no leaves). Leaf ``i`` is ``leaf_{i}`` in the
npz; bfloat16 is stored as its uint16 bits and the float8 types as their
uint8 bits, the dtype's name kept in the json. JAX's ``treedef`` string
cannot be rebuilt without JAX, so the port writes a tree description of
its own (``tree``) and no ``treedef``; restore checks the leaf count,
each leaf's shape and dtype and, where the file has one, the port's tree
description. The sharded checkpoints are not ported yet.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch

from conch_tpu_torch.models.linear import QuantizedLinear

# dtype name -> the unsigned integer type its bits are stored as.
_BITS = {"bfloat16": torch.uint16, "float8_e4m3fn": torch.uint8, "float8_e5m2": torch.uint8}


def _flatten(node: Any, leaves: list) -> Any:
    """Append ``node``'s leaves to ``leaves`` in JAX's order; return the
    tree's description."""
    if node is None:
        return None
    if isinstance(node, QuantizedLinear):
        keys = sorted(node.arrays)
        leaves.extend(node.arrays[k] for k in keys)
        return {"linear": node.kind, "arrays": keys}
    if isinstance(node, dict):
        keys = sorted(node)
        return {"dict": {k: _flatten(node[k], leaves) for k in keys}}
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [_flatten(c, leaves) for c in node]}
    leaves.append(node)
    return "leaf"


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken from the iterator."""
    if template is None:
        return None
    if isinstance(template, QuantizedLinear):
        return QuantizedLinear(template.kind, {k: next(leaves) for k in sorted(template.arrays)}, dict(template.meta))
    if isinstance(template, dict):
        restored = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: restored[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(c, leaves) for c in template)
    return next(leaves)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as numpy, bfloat16 and float8 as their raw bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    bits = _BITS.get(_dtype_name(leaf))
    return (leaf if bits is None else leaf.view(bits)).numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A leaf from the npz (a writable copy), raw bits viewed as their dtype."""
    t = torch.from_numpy(np.array(arr))
    return t.view(getattr(torch, dtype_name)) if dtype_name in _BITS else t


def save_checkpoint(path: str | pathlib.Path, params: Any) -> None:
    """Save a param tree (dense or quantized) to ``path`` (.npz + .json)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves: list = []
    tree = _flatten(params, leaves)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    dtypes = {f"leaf_{i}": _dtype_name(leaf) for i, leaf in enumerate(leaves)}
    np.savez(str(path.with_suffix(".npz")), **arrays)
    meta = {"tree": tree, "dtypes": dtypes, "num_leaves": len(leaves)}
    path.with_suffix(".json").write_text(json.dumps(meta))


def restore_checkpoint(path: str | pathlib.Path, params_like: Any) -> Any:
    """Restore a param tree saved by either package's ``save_checkpoint``.

    ``params_like`` gives the tree's structure and each leaf's device (for
    example a fresh ``init_llama_params`` tree of the same config and quant
    mode). Raises ValueError if the leaf count, a leaf's shape or dtype, or
    the port's tree description (where the file has one) differs.
    """
    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    data = np.load(str(path.with_suffix(".npz")))
    leaves_like: list = []
    tree = _flatten(params_like, leaves_like)
    if len(leaves_like) != meta["num_leaves"]:
        msg = (
            f"Checkpoint has {meta['num_leaves']} leaves but template has {len(leaves_like)} - "
            "config/quant mode mismatch?"
        )
        raise ValueError(msg)
    saved_tree = meta.get("tree")
    if saved_tree is not None and saved_tree != json.loads(json.dumps(tree)):
        msg = f"Checkpoint tree structure does not match the template tree:\n  saved:    {saved_tree}\n  template: {tree}"
        raise ValueError(msg)
    restored = []
    for i, like in enumerate(leaves_like):
        dtype_name = meta["dtypes"][f"leaf_{i}"]
        arr = _from_numpy(data[f"leaf_{i}"], dtype_name)
        like_shape = tuple(like.shape) if isinstance(like, torch.Tensor) else np.asarray(like).shape
        if tuple(arr.shape) != like_shape or dtype_name != _dtype_name(like):
            msg = (
                f"Checkpoint leaf {i} is {tuple(arr.shape)}/{dtype_name} but the template expects "
                f"{like_shape}/{_dtype_name(like)}"
            )
            raise ValueError(msg)
        restored.append(arr.to(like.device) if isinstance(like, torch.Tensor) else arr)
    return _unflatten(params_like, iter(restored))
