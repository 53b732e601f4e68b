"""Trees of tensors: the batches, warm states and solutions the entry
points pass around (dataclasses, named tuples, dicts, tuples and lists
of tensors), mapped leaf by leaf, and padded along their batch axis."""

from __future__ import annotations

import dataclasses

import torch


def map_tree(fn, tree):
    """``fn`` applied to every tensor leaf of a dataclass, named tuple,
    dict, tuple or list of tensors (None leaves stay None)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_tree(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def leaves(tree) -> list:
    """The tensor leaves of ``tree``, in order."""
    out = []
    map_tree(out.append, tree)
    return out


def pad_batch(tree, multiple: int, axis: int = 0):
    """Pad the batch axis (``axis``: 0 batch-leading, -1 batch-last) of
    every leaf up to a multiple of ``multiple`` by repeating the last
    instance. Returns ``(padded tree, original batch size)``."""
    b = leaves(tree)[0].shape[axis]
    pad = (-b) % multiple
    if pad == 0:
        return tree, b

    def edge(a):
        last = a.narrow(axis, a.shape[axis] - 1, 1)
        reps = [1] * a.dim()
        reps[axis] = pad
        return torch.cat([a, last.repeat(*reps)], dim=axis)

    return map_tree(edge, tree), b
