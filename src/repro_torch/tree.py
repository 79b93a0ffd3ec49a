"""Nested containers of tensors ("trees"), walked in the JAX package's order.

The training state is dicts, lists and NamedTuples of tensors, as the
reference's pytrees are. These helpers flatten them as `jax.tree` does:
dict keys sorted, list and tuple items in order, NamedTuple fields in
declaration order, None an empty subtree. Anything else is a leaf: a
tensor, or a `parallel.collectives.DistArray` (a laid-out state's leaf). `leaves_with_path` names each
leaf as the reference's checkpoint does: a dict key as itself, a list
index as its number, a NamedTuple field as ``.field``, joined by ``|``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "leaves_with_path", "unflatten", "tree_map"]

SEP = "|"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield "." + name, getattr(tree, name)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield str(i), x


def _is_leaf(tree) -> bool:
    return tree is not None and not isinstance(tree, (dict, list, tuple))


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) for every leaf of `tree`, in flattening order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_path(child, f"{prefix}{SEP}{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    """The leaves of `tree`, in flattening order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(template, values) -> Any:
    """`template`'s structure with its leaves replaced, in flattening order,
    by `values`."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}          # keep the template's order
        items = [build(x) for _, x in _children(t)]
        return type(t)(*items) if _is_namedtuple(t) else type(t)(items)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
