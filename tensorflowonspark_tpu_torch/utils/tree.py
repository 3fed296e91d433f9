"""Pytree helpers over dicts, tuples and lists (the port's stand-in for
``jax.tree_util``); no ``torch`` import, so the feed plane can use
them."""


def leaves(tree):
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dicts, tuples and lists (nested), with
    ``rest`` trees of the same structure as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
