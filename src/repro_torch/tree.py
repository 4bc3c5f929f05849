"""Trees of tensors in JAX's flatten order.

``jax.tree_util`` flattens a dict in sorted key order and a list or tuple
in its own order, while a Python dict iterates in insertion order.  The
port's checkpoints and ``global_norm`` walk its parameter trees in JAX's
order, so a checkpoint written by either package restores into the right
leaves of the other (two leaves of one shape, such as ``wk`` and ``wv``,
would pass every shape check in the wrong order), and a sum over the
leaves adds them in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _flatten_with_path(tree, prefix=()):
    """(path, leaf) pairs in JAX's flatten order, each path entry rendered
    as JAX renders its key-path entries (``DictKey(key='wq')``,
    ``SequenceKey(idx=0)``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k],
                                          prefix + (f"DictKey(key={k!r})",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten_with_path(x, prefix + (f"SequenceKey(idx={i})",))
    else:
        yield prefix, tree


def _path_str(path: Tuple[str, ...]) -> str:
    """``str()`` of the key-path tuple, exactly as Python prints it."""
    if len(path) == 1:
        return f"({path[0]},)"
    return "(" + ", ".join(path) + ")"


def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX's flatten order."""
    return [leaf for _, leaf in _flatten_with_path(tree)]


def tree_flatten_with_paths(tree) -> Tuple[List[Any], List[str]]:
    """(leaves, their key paths as JAX's ``str(path)`` prints them), in
    JAX's flatten order."""
    pairs = list(_flatten_with_path(tree))
    return [leaf for _, leaf in pairs], [_path_str(p) for p, _ in pairs]


def tree_unflatten(template, leaves) -> Any:
    """A tree of ``template``'s structure whose leaves are ``leaves``, given
    in JAX's flatten order."""
    it = iter(leaves)
    missing = object()

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the template's own key order
        if isinstance(t, (list, tuple)):
            return type(t)([build(x) for x in t])
        leaf = next(it, missing)
        if leaf is missing:
            raise ValueError("fewer leaves than the template holds")
        return leaf

    out = build(template)
    if next(it, missing) is not missing:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping ``tree``'s structure."""
    flat = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])
