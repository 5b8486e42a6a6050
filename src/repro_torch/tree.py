"""Parameter trees: nested dicts, lists and tuples of tensors.

The port keeps the reference's pytrees as plain containers, so the leaf
order must be JAX's: dict keys sorted, lists and tuples (NamedTuples
included) in order.  Gradient bucketing (:mod:`repro_torch.train.overlap_grads`)
and the optimizer walk trees in this order, so bucket ``k`` of the port
holds the same leaves as bucket ``k`` of the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def _is_node(x: Any) -> bool:
    """Dicts, lists and tuples, except a tuple type that declares itself a
    leaf (``tree_leaf = True``, as a partition spec does)."""
    return isinstance(x, (dict, list, tuple)) and not getattr(x, "tree_leaf", False)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if _is_node(tree):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def _rebuild(template: Any, it: Iterator[Any]) -> Any:
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(x, it) for x in template))
    if _is_node(template):
        return type(template)(_rebuild(x, it) for x in template)
    return next(it)


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` (flatten order)."""
    it = iter(leaves)
    out = _rebuild(template, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
