"""Leaves of a solver state, in ``jax.tree_util.tree_leaves`` order.

A state here is a NamedTuple (``MaxSumState``, ``DecimationState``)
whose fields are tensors, numpy arrays or tuples of them.  Its leaves
are listed depth first, fields in declaration order, which is the order
``jax.tree_util`` gives the reference's states of the same shape: so a
snapshot's ``leaf_<i>`` means the same array in both packages
(``resilience/checkpoint.py``), and the recovery noise folds the same
leaf index into its key (``resilience/recovery.py``).
"""

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``: every element that is not a tuple or a
    list, depth first."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure (NamedTuples, tuples, lists) filled with
    ``leaves`` in order; their count must be the template's."""
    if len(leaves) != len(tree_leaves(template)):
        raise ValueError(
            f"{len(leaves)} leaves for a template of "
            f"{len(tree_leaves(template))}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(template)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])
