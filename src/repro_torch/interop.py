"""Parameter bridge between the JAX reference's pytrees and the port.

The reference's parameters, taken to the host with
``jax.tree.map(np.asarray, params)``, are a nested dict of numpy arrays.
:func:`from_numpy` turns such a tree into the port's tensors (same keys,
same layouts: ``(d_in, d_out)`` weights, layer leaves stacked on a leading
``L`` axis) and :func:`to_numpy` turns a port tree back. Neither imports
JAX: bfloat16 arrays (``ml_dtypes.bfloat16``, which is what ``np.asarray``
gives for a bf16 JAX array) are recognized by their dtype name and moved
bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import as_dtype

__all__ = ["from_numpy", "to_numpy", "tree_map", "tree_map_with_keys",
           "tree_get", "tree_leaves", "tree_paths"]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict, keeping the keys."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map_with_keys(fn, tree, keys: Tuple[str, ...] = ()):
    """``fn(keys, leaf)`` on every leaf of a nested dict, ``keys`` the
    leaf's path as a tuple of keys, keeping the keys."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_keys(fn, v, keys + (str(k),))
                for k, v in tree.items()}
    return fn(keys, tree)


def tree_get(tree, keys: Tuple[str, ...]):
    """The entry of a nested dict at the path ``keys``."""
    for k in keys:
        tree = tree[k]
    return tree


def tree_leaves(tree, prefix: str = ""):
    """``[(dotted path, leaf)]`` in key order (``layers.attn.wq``)."""
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out += tree_leaves(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def tree_paths(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``{key: leaf}`` in ``jax.tree_util``'s flattening order: dict keys
    sorted, list and tuple entries by index, parts joined by ``/``
    (``layers/attn/wq``) — the checkpoint's keys."""
    if isinstance(tree, Mapping):
        out = {}
        for k in sorted(tree):
            out.update(tree_paths(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(tree_paths(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _leaf_from_numpy(a: Any, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy(tree, *, device: Union[str, torch.device],
               dtype: Optional[Union[str, torch.dtype]] = None):
    """Numpy pytree → tensors on ``device`` (float leaves cast to ``dtype``
    when it is given, else kept bit for bit)."""
    dt = as_dtype(dtype) if dtype is not None else None
    return tree_map(lambda a: _leaf_from_numpy(a, device, dt), tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:           # no bf16 numpy type: exact in f32
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy(tree):
    """Tensor pytree → numpy pytree (host copies)."""
    return tree_map(_leaf_to_numpy, tree)
