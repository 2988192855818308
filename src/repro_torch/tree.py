"""Nested containers of tensors ("trees"), the port's stand-in for
``jax.tree``: dicts (visited in sorted key order, as JAX does), named
tuples (``ActState``, ``AdamWState``), lists and tuples; ``None`` is an
empty subtree.  Paths name dict keys, named-tuple fields and sequence
indices, the key strings JAX's ``tree_flatten_with_path`` gives."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

Path = Tuple[str, ...]


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if _is_namedtuple(t0):
        return type(t0)(*(tree_map(fn, *f) for f in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *f) for f in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def tree_flatten_with_path(tree: Any, prefix: Path = ()
                           ) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in JAX's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in tree_flatten_with_path(v, prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(template: Any, leaves: Iterable[Any]) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in the order
    ``tree_leaves`` gives them."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
