"""Parameter trees: nested dicts and NamedTuples of tensors, walked the way
``jax.tree_util`` walks them (dict keys sorted, NamedTuple fields in order,
``None`` a subtree with no leaves), so that a leaf's path reads as JAX's
``tree_flatten_with_path`` would print it: ``.params/embed/tok``."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in leaves_with_paths(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaves_with_paths(tree[k], path + (str(k),))]
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """A tree of ``template``'s structure holding ``new_leaves`` in the
    order ``leaves(template)`` gives."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the template's key order
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))])
