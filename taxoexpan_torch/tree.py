"""Parameter trees: nested dicts and lists of tensors (the JAX package's
pytree layout). Dict keys are visited in sorted order, as jax.tree_util
flattens them."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list:
    """(key path, leaf) pairs in tree_leaves order; a path is the tuple of
    dict keys and list indices leading to the leaf, as
    jax.tree_util.tree_flatten_with_path gives them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_leaves_with_path(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_unflatten(template, leaves) -> object:
    """A tree shaped like `template` holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
