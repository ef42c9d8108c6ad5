"""Parameter trees as the port keeps them: nested dicts, lists, tuples
and NamedTuples with tensors (or any other object) at the leaves.

The counterparts of ``jax.tree.leaves`` / ``jax.tree.map`` that the
optimizer and the checkpoint need.  Dict keys are visited in sorted
order, as JAX visits them, so two trees built in different key orders
flatten alike."""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> list:
    """The leaves of ``tree``, depth first, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(example, flat):
    """A tree of ``example``'s structure whose leaves are ``flat``, in the
    order :func:`leaves` gives them."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(example)
