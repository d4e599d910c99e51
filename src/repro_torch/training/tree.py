"""The port's pytrees: nested dicts whose leaves are tensors.

JAX flattens a dict in sorted-key order, and the reference's sums over
leaves (``global_norm``) and its checkpoint files follow that order;
:func:`leaves` and :func:`items` walk it the same way, whatever order
the dicts were built in.
"""

from __future__ import annotations

from typing import Callable, Iterator


def items(tree: dict, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """(path, leaf) pairs in sorted-key order, the path a tuple of keys."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which share its structure down to ``tree``'s leaves)."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def map_with_path(fn: Callable, tree: dict, prefix: tuple = ()) -> dict:
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    return {k: (map_with_path(fn, v, prefix + (k,)) if isinstance(v, dict)
                else fn(prefix + (k,), v))
            for k, v in tree.items()}


def unzip(tree: dict, n: int) -> tuple[dict, ...]:
    """A tree of n-tuples as n trees."""
    return tuple(_pick(tree, i) for i in range(n))


def _pick(tree: dict, i: int) -> dict:
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
