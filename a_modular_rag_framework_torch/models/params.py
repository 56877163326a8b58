"""Model parameters between the two packages' forms.

The JAX package keeps a model's parameters as a nested dict / list tree of
arrays and saves it as a flat ``.npz`` keyed by ``jax.tree_util.keystr``
paths (``"['layers'][0]['wqkv']"``, ``"['splade_head']['lex_w']"``). The
port keeps the same tree, with torch tensors as leaves and JAX's weight
layout (``[in, out]``, applied as ``x @ w``), so one checkpoint file serves
both packages: `flatten_params` / `unflatten_params` go between a tree and
the flat numpy dict, `save_params` / `load_params` between a tree and a
file. Nothing here imports jax; the key strings are built by hand.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Any  # nested dict / list with torch.Tensor leaves


def _walk(tree: Tree, prefix: str = ""):
    """(keystr path, leaf) pairs in jax's flatten order (dict keys sorted,
    list items by index)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree: Tree) -> list:
    """The leaves in jax's flatten order."""
    return [v for _, v in _walk(tree)]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """A tree shaped like ``tree`` whose leaves are ``fn(leaf, *others)``,
    the others taken from the same place in ``rest``; leaves are visited in
    jax's flatten order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(template: Tree, leaves) -> Tree:
    """A tree shaped like ``template`` holding ``leaves`` (in
    `tree_leaves`' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def flatten_params(tree: Tree) -> Dict[str, np.ndarray]:
    """Port tree -> {keystr path: numpy array}: the JAX package's
    checkpoint keys and values."""
    return {k: v.detach().cpu().numpy() for k, v in _walk(tree)}


def unflatten_params(flat, template: Tree, *, device,
                     source: str = "the given arrays",
                     hint: str = "") -> Tree:
    """{keystr path: array} -> a tree shaped like ``template`` with f32
    (or the template leaf's dtype) tensors on ``device``. A missing key
    raises KeyError and a shape mismatch ValueError, as the JAX loaders
    do; keys the template does not name are ignored."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
        if prefix not in flat:
            raise KeyError(f"missing weight {prefix} in {source}")
        arr = np.asarray(flat[prefix])
        if arr.shape != tuple(node.shape):
            raise ValueError(
                f"shape mismatch for {prefix}: {arr.shape} vs "
                f"{tuple(node.shape)}" + (f" — {hint}" if hint else ""))
        # ascontiguousarray turns a 0-dim array into [1]: keep the shape
        return torch.from_numpy(np.ascontiguousarray(arr)).reshape(
            arr.shape).to(device=device, dtype=node.dtype)

    return build(template, "")


def save_params(path: str, tree: Tree,
                extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write the JAX package's checkpoint layout (``np.savez`` appends
    ``.npz`` to a path without it, as there)."""
    np.savez(path, **(extra or {}), **flatten_params(tree))


def load_params(path: str, template: Tree, *, device, hint: str = "") -> Tree:
    """Read a checkpoint written by either package into ``template``'s
    shape."""
    with np.load(path) as data:
        return unflatten_params(data, template, device=device, source=path,
                                hint=hint)
