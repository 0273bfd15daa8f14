"""Nested dicts (and lists / tuples) of tensors, walked in the reference's
leaf order: dict keys sorted, sequences by index — the order of
``jax.tree_util.tree_flatten_with_path``, so the ``/``-joined paths
(``params/layers/wq``, ``opt/step``) equal the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

SEP = "/"
_END = object()


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    else:
        for i, v in enumerate(tree):
            yield str(i), v


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in leaf order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in _children(tree):
        out += flatten_with_paths(v, f"{prefix}{SEP}{k}" if prefix else k)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def unflatten_like(template, values) -> Any:
    """The tree of ``template``'s shape holding ``values`` in leaf order."""
    it = iter(values)
    out = map_tree(lambda _: next(it), template)
    if next(it, _END) is not _END:
        raise ValueError("more values than the template has leaves")
    return out


def to_dict(tree) -> Dict[str, Any]:
    return dict(flatten_with_paths(tree))
