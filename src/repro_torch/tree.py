"""Pytrees of the port: nested dicts and dataclasses over tensor leaves,
flattened in the order ``jax.tree_util`` flattens the reference's (a
dict's keys sorted, a dataclass's fields in declaration order), with
each leaf's path of keys.

A *group* — a list of tensors — is one leaf that the reference stores
stacked on a leading axis.  The reference stacks each pattern
position's parameters over the periods of layers; the port keeps its
layers apart (``nn.ModuleList``), so the view of a model as the
reference's leaves (``models.param_tree``) lists the per-layer tensors
of a stacked leaf.  What the reference computes per leaf — the
compressor's scale and top-k, the checkpoint's keys and shapes — runs
on :func:`stacked`; what is elementwise or a sum runs per tensor
(:func:`map_tensors`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

Path = tuple[str, ...]


def is_group(leaf: Any) -> bool:
    return isinstance(leaf, list)


def _is_node(tree: Any) -> bool:
    return isinstance(tree, dict) or (dataclasses.is_dataclass(tree)
                                      and not isinstance(tree, type))


def leaves_with_paths(tree: Any, path: Path = ()
                      ) -> Iterator[tuple[Path, Any]]:
    """Every leaf (a tensor, an array, a scalar or a group) with its
    path, in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (str(k),))
    elif _is_node(tree):
        for f in dataclasses.fields(tree):
            yield from leaves_with_paths(getattr(tree, f.name),
                                         path + (f.name,))
    else:
        yield path, tree


def key_of(path: Path) -> str:
    """The reference checkpoint's key of a leaf: its path joined by
    ``/``."""
    return "/".join(path)


def _map(fn: Callable, tree: Any, rest: tuple, with_path: bool, path: Path,
         groups: bool) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, tuple(r[k] for r in rest), with_path,
                        path + (str(k),), groups)
                for k, v in tree.items()}
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         tuple(getattr(r, f.name) for r in rest), with_path,
                         path + (f.name,), groups)
            for f in dataclasses.fields(tree)})
    if groups and is_group(tree):
        return [_map(fn, t, tuple(r[i] for r in rest), with_path, path,
                     groups) for i, t in enumerate(tree)]
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)


def map_leaves(fn: Callable, tree: Any, *rest: Any,
               with_path: bool = False) -> Any:
    """``fn([path,] leaf, *leaves of rest)`` over congruent trees; a
    group is one leaf."""
    return _map(fn, tree, rest, with_path, (), False)


def map_tensors(fn: Callable, tree: Any, *rest: Any,
                with_path: bool = False) -> Any:
    """``fn([path,] t, *ts)`` over every tensor of congruent trees, the
    members of a group one by one (their path is the group's)."""
    return _map(fn, tree, rest, with_path, (), True)


def tensors(tree: Any) -> list:
    """Every tensor of the tree in leaf order, a group's members in
    order."""
    out = []
    for _, leaf in leaves_with_paths(tree):
        out.extend(leaf if is_group(leaf) else [leaf])
    return out


def unflatten_tensors(tree: Any, flat: list) -> Any:
    """The tree of ``tree``'s structure holding ``flat`` (as
    :func:`tensors` lists them)."""
    order = {id(t): i for i, t in enumerate(tensors(tree))}
    return map_tensors(lambda t: flat[order[id(t)]], tree)


def stacked(leaf: Any) -> torch.Tensor:
    """The reference's array of a leaf: a group stacked on a new
    leading axis."""
    return torch.stack(leaf) if is_group(leaf) else leaf


def unstacked(t: torch.Tensor, like: Any) -> Any:
    """``t`` split back into a group where ``like`` is one."""
    return list(t.unbind(0)) if is_group(like) else t


def leaf_shape(leaf: Any) -> tuple[int, ...]:
    if is_group(leaf):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)
